"""RaLM serving on the PyTorch port across all three retriever types with the
full PSA feature set (the paper's Figure 4 in miniature), as
``examples/ralm_serving.py`` does with the JAX package.

    PYTHONPATH=src python examples/ralm_serving_torch.py [--device cpu]

Runs on the card unless ``--device cpu``. EDR and ADR scan through the
kernel backend (B1 and B4 on the card, their plain versions on the CPU); SR
scores BM25 on the host, as in the reference.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import build_stack, make_server, variant_config
from repro_torch.training.data import make_queries


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    rcfg = variant_config("psa", RaLMConfig(max_new_tokens=32))
    for retriever in ("edr", "adr", "sr"):
        stack = build_stack(retriever, n_docs=8000, rcfg=rcfg, device=device,
                            backend="numpy" if retriever == "sr" else "kernel")
        prompt = (make_queries(stack.docs, 1, seed=4)[0] * 12)[:48]
        base = make_server(stack, scheduler="seq").serve(prompt)
        spec = make_server(stack, scheduler="single").serve(prompt)
        assert base.tokens == spec.tokens
        print(f"{retriever.upper():3s}: baseline {base.kb_calls:2d} KB calls -> "
              f"ralmspec {spec.kb_calls:2d} calls "
              f"(rounds={spec.rounds}, rollbacks={spec.mismatches}, "
              f"outputs identical)")


if __name__ == "__main__":
    main()
