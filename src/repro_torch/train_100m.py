"""End-to-end training script: ~100M-parameter model, few hundred steps (the
twin of the JAX package's ``examples/train_100m.py``, same flags and lines).

Demonstrates the full train substrate: synthetic packed data pipeline,
AdamW + cosine schedule + remat + (optional) int8 gradient compression,
async checkpointing, and crash-safe restart (rerun the same command and it
resumes from the last committed step).

    PYTHONPATH=src python -m repro_torch.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.train_100m --steps 300  # resumes
    PYTHONPATH=src python -m repro_torch.train_100m --device cpu --steps 4

Defaults are sized for smoke runs; --full-100m builds the real ~100M config
(yi-100m: 12 layers, d_model 768, 12/4 heads of 64, vocab 32 000).  The
device defaults to the card; bf16 compute over fp32 master weights.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, packed_batches
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def build_config(full: bool):
    base = get_config("yi-9b")
    if full:
        # ~100M params: 12L, d=768, vocab 32k
        return dataclasses.replace(
            base, name="yi-100m", n_layers=12, d_model=768, n_q_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32_000,
            max_seq_len=1024)
    return dataclasses.replace(
        base, name="yi-20m", n_layers=4, d_model=256, n_q_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=8_000,
        max_seq_len=512)


def train_config(steps: int, grad_compression: bool = False) -> TrainConfig:
    """The example's settings: lr 6e-4, warmup 20, remat, 2 microbatches."""
    return TrainConfig(
        opt=AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=steps),
        remat=True, microbatches=2, grad_compression=grad_compression)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = build_config(args.full_100m)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    tcfg = train_config(args.steps, args.grad_compression)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch, seed=0)
    trainer = Trainer(cfg, tcfg, iter(packed_batches(dc)),
                      checkpoint_dir=args.ckpt, checkpoint_every=50,
                      device=args.device)
    if trainer.step:
        print(f"resumed from checkpoint at step {trainer.step}")
    history = trainer.run(args.steps - trainer.step, log_every=10)
    for h in history:
        print(f"step {h['step']:4d} nll={h['nll']:.3f} "
              f"acc={h['accuracy']:.3f} gnorm={h['grad_norm']:.2f} "
              f"lr={h['lr']:.2e} wall={h['wall']:.0f}s")
    if history:
        first, last = history[0], history[-1]
        print(f"loss {first['nll']:.3f} -> {last['nll']:.3f} "
              f"over {last['step'] - first['step']} steps")
    return history


if __name__ == "__main__":
    main()
