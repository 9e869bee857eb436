"""End-to-end training entry point (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --reduced \
        --steps 200 --batch 8 --seq 128                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llama3.2-1b \
        --reduced --steps 3                             # on the CPU

Synthetic LM data (``training.data.SyntheticLM``, batch ``step`` at step
``step``), AdamW with 20 warmup steps and a cosine over ``--steps``, periodic
checkpoints in the reference's format. Parameters are drawn from a
``torch.Generator`` seeded 0 on the device. ``--device`` defaults to ``cuda``
and raises without a card. Without ``--reduced`` it trains the arch as
published (``--arch knnlm-247m``: the paper's KNN-LM base model, 247M
parameters). fp32 throughout, TF32 off.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.trainer import init_train, make_train_step, to_device


def add_extra(cfg, batch: dict) -> dict:
    """Zero encoder frames (audio) or image patches (VLM), as the reference
    launcher feeds them."""
    B = batch["tokens"].shape[0]
    if cfg.family == "audio":
        batch["frames"] = np.zeros((B, cfg.encoder_frames, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        batch["patches"] = np.zeros((B, cfg.vision_patches, cfg.d_model), np.float32)
    return batch


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4, device=None,
          ckpt_dir=None, ckpt_every: int = 100, log_every: int = 10):
    """Train ``cfg`` for ``steps`` steps on ``device`` (default CUDA) ->
    (model, params, opt_state, history): history holds each step's
    ``loss``, ``grad_norm`` and ``ms`` (CUDA events on the card, the host
    clock on the CPU; read after the last step, so no step waits for one)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model, params, opt_state = init_train(cfg, gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M layers={cfg.num_layers} "
        f"d={cfg.d_model} device={dev}")
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    cuda = dev.type == "cuda"
    marks, metrics = [], []

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    t0 = time.time()
    marks.append(mark())
    for step in range(1, steps + 1):
        b = to_device(add_extra(cfg, data.batch(step)), dev)
        params, opt_state, m = step_fn(params, opt_state, b)
        marks.append(mark())
        metrics.append(m)
        if step % log_every == 0 or step == 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
                f"({(time.time() - t0) / step:.2f}s/step)")
        if ckpt_dir and step % ckpt_every == 0:
            print(f"  checkpoint -> {save_checkpoint(ckpt_dir, step, cfg, params, opt_state)}")
    if cuda:
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    history = {"loss": [float(m["loss"]) for m in metrics],
               "grad_norm": [float(m["grad_norm"]) for m in metrics], "ms": ms}
    print(f"done in {time.time() - t0:.1f}s")
    return model, params, opt_state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          device=resolve_device(args.device), ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, log_every=args.log_every)


if __name__ == "__main__":
    main()
