"""How the rounding of the SSM causal conv moves the bf16 teacher-forced
agreement, and the serving times, of full-width mamba2-370m and
hymba-1.5b on the card.

    python3 tools/conv_rounding.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Serves
``chip_smoke.py``'s phase-5 job (8 requests, prompts of 128-1024 tokens,
32 new tokens each, random bf16 weights from seed 0) with each variant
of ``repro_torch.models.ssm.causal_conv`` swapped in, in the order
fp32, bf16, jax, jax, bf16, fp32, so that a drift of the machine over
the call shows as a difference between the two runs of one variant.
For each run it prints the share of generated tokens that equal a
teacher-forced forward's argmax (the mean over the 8 requests, which
``chip_smoke.py`` gates at 0.9, and each request's own), the wall time,
the mean TTFT and the decode tokens/s after the last first token.

Variants:

  fp32  the port's conv: products and their sum in fp32, rounded once to
        bf16, in prefill (and the teacher-forced forward) and in decode;
  bf16  products and partial sums each rounded to bf16, in both;
  jax   the JAX package's pair: bf16 sums in prefill, the fp32 sum
        rounded once in decode (decode is the conv's only one-token call
        in this job).

The last line is one JSON object with the card and every reading.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def bf16_sums(stream, w, b, init):
    """The conv with every product and partial sum in the stream's dtype."""
    L, W = stream.shape[1], w.shape[0]
    padded = torch.cat([init, stream], dim=1)
    out = sum(padded[:, i:i + L] * w[i] for i in range(W))
    return F.silu(out + b), padded[:, L:]


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_rounding: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.models import ssm

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    fp32_conv = ssm.causal_conv

    def jax_pair(stream, w, b, init):
        conv = fp32_conv if stream.shape[1] == 1 else bf16_sums
        return conv(stream, w, b, init)

    variants = {"fp32": fp32_conv, "bf16": bf16_sums, "jax": jax_pair}
    order = ("fp32", "bf16", "jax", "jax", "bf16", "fp32")
    readings = []
    for arch in ("mamba2-370m", "hymba-1.5b"):
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
        prompts = cs.full_width_prompts(cfg)
        cs.serve(cfg, params, prompts[:1], 4, "cuda", **cs.PAGED,
                 **cs.FULL_WIDTH_ENGINE)                  # warm-up
        for name in order:
            ssm.causal_conv = variants[name]
            try:
                fin, _, wall = cs.serve(cfg, params, prompts, 32, "cuda",
                                        **cs.PAGED, **cs.FULL_WIDTH_ENGINE)
                per_req = [cs.teacher_forced_agreement(
                    cfg, params, prompts[r], fin[r].generated)
                    for r in sorted(fin)]
            finally:
                ssm.causal_conv = fp32_conv
            mean = sum(per_req) / len(per_req)
            ttft, decode_rate = cs.serving_times(fin, wall)
            ttft_ms = 1e3 * sum(ttft) / len(ttft)
            print(f"{arch} conv {name}: agreement {mean:.4f}, min "
                  f"{min(per_req):.4f}, per request "
                  f"{[round(a, 4) for a in per_req]}; wall {wall:.3f} s, "
                  f"TTFT mean {ttft_ms:.1f} ms, decode {decode_rate:.1f} "
                  "tok/s", flush=True)
            readings.append({"arch": arch, "conv": name, "agreement": mean,
                             "per_request": per_req, "wall_s": wall,
                             "ttft_mean_ms": ttft_ms,
                             "decode_tok_s": decode_rate})
        del params
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
