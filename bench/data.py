"""Everything a run serves, made from its seed: the weights, the encoder's
token table, the topical corpus, the KB or datastore, on the device in a few
large calls, then copied to the host where the port's interfaces take host
arrays (the KB, the encoder table).

The same inputs go to the program and to the plain reference. Each part has
its own generator, derived from the seed and a tag, so a part can be made
again alone. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench import cells

_TAGS = {"params": 1, "table": 2, "corpus": 3, "heldout": 4}


def generator(seed: int, part: str, device) -> torch.Generator:
    """A generator on ``device`` for one part of the run, from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + _TAGS[part]) % (1 << 63))
    return g


def param_layout(cfg: dict, model=None) -> list:
    """(path, shape, kind, scale) of every leaf, in draw order, in the port's
    parameter layout: the configuration's model module's (``model``, or
    ``bench.cells.model``'s)."""
    return (model or cells.model(cfg)).param_layout(cfg)


def nest(leaves) -> dict:
    """The parameter tree of (path, leaf) pairs: a path's keys are dict keys,
    its ints list indices."""
    tree: dict = {}
    for path, leaf in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return lists(tree)


def make_params(cfg: dict, seed: int, device, model=None) -> dict:
    """All weights in one normal draw on ``device``, cut into the leaves of
    the model module's layout, in its order: matrices z times their init
    scale, norms 1 + 0.1 z, biases 0.02 z."""
    layout = param_layout(cfg, model)
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    flat = torch.empty((total,), dtype=torch.float32, device=device)
    flat.normal_(generator=generator(seed, "params", device))
    leaves, off = [], 0
    for path, shape, kind, scale in layout:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if kind == "w":
            leaf.mul_(scale)
        elif kind == "norm":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(0.02)
        leaves.append((path, leaf))
    return nest(leaves)


def make_table(vocab: int, dim: int, seed: int, device) -> torch.Tensor:
    """The encoder's token table (vocab, dim): unit rows, on ``device``."""
    t = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    t.normal_(generator=generator(seed, "table", device))
    return t / torch.linalg.vector_norm(t, dim=1, keepdim=True)


class Topics:
    """The topical corpus: ``topics`` clusters of ``topic_words`` word ids
    each; a token of item i (a document or passage, in order) is one of its
    topic's words with probability ``topical_share``, else any word; items
    in order share topics, as the port's ``synthetic_corpus`` lays them out
    (``n_items / topics`` consecutive items a topic).
    """

    def __init__(self, spec: dict, vocab: int, n_items: int, seed: int, device):
        self.spec, self.vocab, self.n_items = spec, vocab, n_items
        self.device = device
        self.gen = generator(seed, "corpus", device)
        self.words = torch.randint(2, vocab, (spec["topics"], spec["topic_words"]),
                                   generator=self.gen, device=device)

    def draw(self, topic: torch.Tensor, length: int, gen: torch.Generator) -> torch.Tensor:
        """Tokens (len(topic), length) int64 of items of the given topics."""
        s, dev, n = self.spec, self.device, len(topic)
        pick = torch.randint(0, s["topic_words"], (n, length), generator=gen, device=dev)
        topical = self.words[topic[:, None], pick]
        background = torch.randint(2, self.vocab, (n, length), generator=gen, device=dev)
        mask = torch.rand((n, length), generator=gen, device=dev) < s["topical_share"]
        return torch.where(mask, topical, background)

    def items(self, lo: int, hi: int, length: int) -> torch.Tensor:
        """Tokens (hi - lo, length) int64 of items lo..hi-1, drawn in order:
        call with consecutive ranges."""
        topic = (torch.arange(lo, hi, device=self.device) * self.spec["topics"]) // self.n_items
        return self.draw(topic, length, self.gen)

    def held_out(self, n_items: int, length: int, seed: int) -> torch.Tensor:
        """Tokens (n_items, length) int64 of held-out text: runs of as many
        items a topic as the corpus has, on topics spread evenly over all
        of them, drawn from a generator of their own, so that none of it is
        the corpus's own text (kNN-LM's datastore is built from training
        text and evaluated on held-out text)."""
        run = max(self.n_items // self.spec["topics"], 1)
        article = torch.arange(n_items, device=self.device) // run
        n_articles = -(-n_items // run)
        topic = (article * self.spec["topics"]) // n_articles
        return self.draw(topic, length, generator(seed, "heldout", self.device))


def make_stream(spec: dict, vocab: int, n_tokens: int, seed: int, device) -> tuple:
    """The corpus token stream of ``n_tokens`` and the held-out stream of
    ``spec["heldout_tokens"]`` (int64, on ``device``): documents of
    ``doc_tokens`` tokens one after another."""
    L = spec["doc_tokens"]
    topics = Topics(spec, vocab, -(-n_tokens // L), seed, device)
    stream = topics.items(0, topics.n_items, L).reshape(-1)[:n_tokens]
    n_ho = spec["heldout_tokens"]
    return stream, topics.held_out(-(-n_ho // L), L, seed).reshape(-1)[:n_ho]


def datastore_keys(stream: torch.Tensor, table: torch.Tensor, lo: int, hi: int,
                   context: int, decay: float) -> torch.Tensor:
    """KNN-LM keys of entries lo..hi-1: entry i's context is stream[i : i +
    context], embedded as the recency-weighted sum (the last token weight 1,
    each earlier one ``decay`` times the next) of its tokens' table rows,
    L2-normalised (a 16-tap FIR over the stream, as the port's
    ``build_knn_datastore``)."""
    E = table[stream[lo:hi + context - 1]]
    n = hi - lo
    S = torch.zeros((n, table.shape[1]), dtype=torch.float32, device=table.device)
    for j in range(context):
        S.add_(E[context - 1 - j:context - 1 - j + n], alpha=decay ** j)
    return S / torch.clamp(torch.linalg.vector_norm(S, dim=1, keepdim=True), min=1e-9)


def passage_keys(passages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """DPR-style passage keys: the normalised mean of the passage's token
    rows (the port's ``encode_doc``)."""
    v = torch.nn.functional.embedding_bag(passages, table, mode="mean")
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-9)


def host_array(shape: tuple, dtype: torch.dtype, device) -> np.ndarray:
    """An empty host array; page-locked where the run has a card, so that
    the copies to and from it (the port's upload of the KB among them) run
    at the link's rate and not at the rate of pageable memory's first
    touch."""
    pin = torch.device(device).type == "cuda"
    return torch.empty(shape, dtype=dtype, pin_memory=pin).numpy()


def to_host(n_rows: int, row_shape: tuple, make_block, block_rows: int, device) -> np.ndarray:
    """A host float32 array (n_rows, *row_shape) filled block by block from
    ``make_block(lo, hi)``, a device tensor of those rows: the device holds
    one block at a time."""
    out = host_array((n_rows,) + tuple(row_shape), torch.float32, device)
    host = torch.from_numpy(out)
    for lo in range(0, n_rows, block_rows):
        hi = min(lo + block_rows, n_rows)
        host[lo:hi].copy_(make_block(lo, hi))
    return out


class StreamDocs:
    """The KNN-LM datastore's per-entry payload view: entry i's context
    tokens, made on demand from the stream (the port reads ``docs`` only for
    RaLM's chunks)."""

    def __init__(self, stream: np.ndarray, context: int, n: int):
        self.stream, self.context, self.n = stream, context, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> list:
        return self.stream[int(i):int(i) + self.context].tolist()


class PassageDocs:
    """The KB's passages as the port's ``DenseKB.docs`` reads them: the
    token list of passage i."""

    def __init__(self, passages: np.ndarray):
        self.passages = passages

    def __len__(self) -> int:
        return len(self.passages)

    def __getitem__(self, i: int) -> list:
        return self.passages[int(i)].tolist()


class Corpus:
    """What a run makes once from its seed and hands to the program, the
    traffic generator and the reference: ``model`` (the configuration's
    model module), ``params`` (device, in its layout), ``table``
    (host, (vocab, key_dim)), ``keys`` (host, (rows, key_dim) fp32), and
    ``values`` + ``stream`` + ``heldout`` (KNN-LM) or ``passages`` (RaLM),
    host int32."""

    stream = None
    heldout = None
    values = None
    passages = None

    def __init__(self, cfg: dict, seed: int, device, block_rows: int = 1 << 20, model=None):
        self.cfg, self.seed = cfg, seed
        self.model = model or cells.model(cfg)
        self.params = make_params(cfg, seed, device, self.model)
        table = make_table(cfg["vocab_size"], cfg["key_dim"], seed, device)
        self.table = table.cpu().numpy()
        d = cfg["key_dim"]
        if cfg["workload"] == "knnlm":
            C, n = cfg["encoder_window"], cfg["datastore_rows"]
            stream, heldout = make_stream(cfg["corpus"], cfg["vocab_size"], n + C + 1, seed,
                                          device)
            self.stream = stream.to(torch.int32).cpu().numpy()
            self.heldout = heldout.to(torch.int32).cpu().numpy()
            self.values = self.stream[C:C + n].copy()
            self.keys = to_host(n, (d,), lambda lo, hi: datastore_keys(
                stream, table, lo, hi, C, cfg["encoder_decay"]), block_rows, device)
            self.docs = StreamDocs(self.stream, C, n)
        else:
            n, L = cfg["kb_passages"], cfg["passage_tokens"]
            topics = Topics(cfg["corpus"], cfg["vocab_size"], n, seed, device)
            self.passages = host_array((n, L), torch.int32, device)
            keys = host_array((n, d), torch.float32, device)
            kh, ph = torch.from_numpy(keys), torch.from_numpy(self.passages)
            for lo in range(0, n, block_rows):
                hi = min(lo + block_rows, n)
                toks = topics.items(lo, hi, L)
                ph[lo:hi].copy_(toks.to(torch.int32))
                kh[lo:hi].copy_(passage_keys(toks, table))
            self.keys = keys
            self.docs = PassageDocs(self.passages)
        del table
