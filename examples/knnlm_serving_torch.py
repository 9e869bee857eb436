"""KNN-LM speculative serving on the PyTorch port (paper §5.3): per-token
retrieval with spatial-prefetch caching and token-match verification,
single-request and through the fleet, as ``examples/knnlm_serving.py`` does
with the JAX package.

    PYTHONPATH=src python examples/knnlm_serving_torch.py [--device cpu]

Runs on the card unless ``--device cpu``; the datastore scan is the kernel
backend (B1 on the card, its plain version on the CPU).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import build_stack, make_server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    rcfg = RaLMConfig(knnlm=True, knn_k=8, max_new_tokens=32,
                      speculation_stride=4)
    stack = build_stack("edr", workload="knnlm", arch="knnlm-247m", backend="kernel",
                        n_docs=800, d_model=128, rcfg=rcfg, knn_entries=20_000,
                        device=device)
    print(f"datastore: {stack.retriever.kb.size} (context -> next-token) "
          "entries")

    # prompts are prefixes of the datastore's own token stream — the regime
    # where neighbour retrieval carries signal
    prompts = [stack.stream[i * 97:i * 97 + 48].tolist() for i in range(3)]
    seq = make_server(stack, scheduler="seq")
    base = [seq.serve(p) for p in prompts]
    spec = make_server(stack, scheduler="single").serve(prompts[0])
    assert base[0].tokens == spec.tokens
    print(f"baseline : {base[0].kb_calls} retrievals (one per token)")
    print(f"ralmspec : {spec.kb_calls} batched retrievals, "
          f"{spec.mismatches} rollbacks, outputs identical (token-match)")

    # the fleet: every slot's verification queries merge into ONE batched KB
    # call per round; per-slot token streams still match the baseline
    with make_server(stack, scheduler="fixed", n_slots=3) as fleet:
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == [b.tokens for b in base]
    assert fr.kb_calls == fr.rounds + 1      # 1 seed + 1 merged call per round
    print(f"fleet x3 : {fr.kb_calls} merged KB calls over {fr.rounds} rounds "
          f"for 3 requests, outputs identical (token-match)")


if __name__ == "__main__":
    main()
