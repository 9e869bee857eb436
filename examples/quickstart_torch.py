"""Quickstart on the PyTorch port: build the whole stack at toy scale and
watch RaLMSpec preserve the baseline's output while cutting knowledge-base
calls, as ``examples/quickstart.py`` does with the JAX package.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device cpu``; the KB scan is the kernel backend
(B1 on the card, its plain version on the CPU).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs import RaLMConfig, get_config, reduced
from repro_torch.core.ralmspec import RaLMSeq, RaLMSpec
from repro_torch.models.model import build_model
from repro_torch.retrieval.encoder import ContextEncoder
from repro_torch.retrieval.kb import DenseKB
from repro_torch.retrieval.retrievers import ExactDenseRetriever
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.data import make_queries, synthetic_corpus


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args().device)

    # 1. a host LM (reduced GPT-2-class decoder) ------------------------------
    cfg = reduced(get_config("ralm-gpt2-medium"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # 2. a knowledge base + exact dense retriever ------------------------------
    docs = synthetic_corpus(5000, cfg.vocab_size)
    enc = ContextEncoder(cfg.vocab_size, d=64)
    retriever = ExactDenseRetriever(DenseKB.build(docs, enc), backend="kernel", device=dev)

    # 3. serve one request with the baseline and with RaLMSpec -----------------
    rcfg = RaLMConfig(max_new_tokens=32, speculation_stride=3,
                      prefetch_top_k=20)
    engine = ServeEngine(model, params, cache_window=512)
    prompt = (make_queries(docs, 1)[0] * 12)[:48]

    base = RaLMSeq(engine, retriever, rcfg, enc).serve(prompt)
    spec = RaLMSpec(engine, retriever, rcfg, enc).serve(prompt)

    print(f"baseline : {base.kb_calls} KB calls, {base.wall_time:.2f}s")
    print(f"ralmspec : {spec.kb_calls} KB calls, {spec.wall_time:.2f}s "
          f"({spec.rounds} verification rounds, {spec.mismatches} rollbacks)")
    print(f"outputs identical: {base.tokens == spec.tokens}")
    assert base.tokens == spec.tokens


if __name__ == "__main__":
    main()
