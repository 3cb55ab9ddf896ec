"""Where a re-prefilled stream leaves the uninterrupted one, and how that
moves the bf16 teacher-forced agreement, at full width on the card.

    python3 tools/migrate_agreement.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  For
hymba-1.5b and yi-9b (random bf16 weights from seed 0) it serves
``chip_smoke.py``'s phase-5 job (8 requests, 32 new tokens, horizon 8)
uninterrupted, then migrated by page handoff and by re-prefill after the
source has served each request 1, 9, 17 and 25 tokens (the prefill's
token, then one horizon of 8 at a time).  For each run it prints the
share of generated tokens that equal a teacher-forced forward's argmax
(``chip_smoke.py``'s gate: 0.9 of all 8 requests) and whether the stream
equals the uninterrupted one.  For each request the 9-token re-prefill
run (``chip_smoke.py``'s migrate run) changes, it prints the first
position where the two streams part and, from the teacher-forced forward
over the prompt and the uninterrupted stream, the logits there of the
two tokens and of the forward's own argmax; and, for the uninterrupted
and that re-prefilled stream, the forward's logit gap at every token
that is not its argmax.  A gap of a few bf16 steps is a near-tie that
rounding decides.

    python3 tools/migrate_agreement.py --boundary

Instead asks whether a re-prefill leaves the state the teacher-forced
forward computes.  For the same two models and job it migrates the
requests by re-prefill after ``chip_smoke.py``'s MIGRATE_AFTER tokens,
steps the destination until every request is re-prefilled, and holds
each request's K/V there (``gather_tokens``) against a ``prefill`` of
its context, and that prefill's K/V and last logits against those of a
prefill over the context and the stream's next 22 tokens (the forward's
input), position by position: whether they are bit-equal, the first
layer where they are not, and the share of elements that differ.  It
also checks, on random bf16 inputs of a served shape, whether B2's rows
and a projection's rows depend on how many rows follow them.

The last line is one JSON object with the card and every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
POINTS = (1, 9, 17, 25)


def migrated(cs, cfg, params, prompts, path, after):
    """The job served until every request has ``after`` tokens, moved by
    ``path`` (``chip_smoke.move_inflight``) and finished: streams by
    rid."""
    src, dst = cs.migration_engines(cfg, params, "cuda", path,
                                    **cs.FULL_WIDTH_ENGINE, **cs.PAGED)
    cs.serve_part_way(src, {rid: (p, 32) for rid, p in enumerate(prompts)},
                      after=after)
    cs.move_inflight(src, dst, path)
    return {r.rid: r.generated for r in dst.run_to_completion()}


def parting(cfg, params, prompt, want, got):
    """The first position where ``got`` leaves ``want`` and the teacher-
    forced logits there (the forward over prompt + want)."""
    from repro_torch.models import forward
    from repro_torch.models.sampling import mask_padded_vocab
    d = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    seq = np.concatenate([prompt, np.asarray(want[:d], np.int32)])
    logits = forward(params, cfg, torch.from_numpy(seq[None]).cuda())
    logits = mask_padded_vocab(logits[0, -1:], cfg)[0].float()
    top = int(logits.argmax())
    return {"position": d, "uninterrupted": int(want[d]),
            "migrated": int(got[d]), "forward_argmax": top,
            "logit_uninterrupted": float(logits[want[d]]),
            "logit_migrated": float(logits[got[d]]),
            "logit_argmax": float(logits[top])}


def flip_gaps(cfg, params, prompt, generated) -> list[float]:
    """At each position where a stream's token is not the teacher-forced
    forward's argmax: the forward's logit of its argmax minus its logit of
    the stream's token."""
    from repro_torch.models import forward
    from repro_torch.models.sampling import mask_padded_vocab
    seq = np.concatenate([prompt, np.asarray(generated[:-1], np.int32)])
    logits = forward(params, cfg, torch.from_numpy(seq[None]).cuda())
    logits = mask_padded_vocab(logits[0, len(prompt) - 1:], cfg).float()
    gen = torch.as_tensor(generated, device=logits.device)
    gap = logits.max(-1).values - logits.gather(1, gen[:, None])[:, 0]
    return [round(float(g), 4) for g in gap if g > 0]


def _differ(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Per layer of two [L, S, ...] tensors: the first layer that is not
    bit-equal (None if all are), and the share of elements that differ in
    that layer and in the last."""
    neq = (a != b).flatten(1).float().mean(1)
    bad = torch.nonzero(neq).flatten().tolist()
    return {"first_layer": bad[0] if bad else None,
            "share_first": float(neq[bad[0]]) if bad else 0.0,
            "share_last": float(neq[-1])}


def ssd_rows(cfg, params, x: torch.Tensor, S: int) -> dict:
    """Whether the first ``S`` rows of layer 0's SSD mixer, and of each
    step of its chunked scan, are bit-equal when rows follow them
    (``x`` [1, S + extra, d_model] holds them)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import ssm as ssm_lib
    p = {k: v[0] for k, v in params["blocks"]["ssm"].items()}
    out = {"ssm_forward_rows_independent": bool(torch.equal(
        ssm_lib.ssm_forward(x[:, :S], p, cfg)[0],
        ssm_lib.ssm_forward(x, p, cfg)[0][:, :S]))}
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    gen = torch.Generator(device=x.device)
    gen.manual_seed(1)
    L = x.shape[1]

    def rand(*shape):
        return torch.randn(1, L, *shape, generator=gen, device=x.device)

    xs, B_, C_ = rand(H, P), rand(G, N), rand(G, N)
    dt = F.softplus(rand(H) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y_s, _ = ssm_lib.ssd_chunked(xs[:, :S], dt[:, :S], A, B_[:, :S],
                                 C_[:, :S], cfg.ssm_chunk)
    y_l, _ = ssm_lib.ssd_chunked(xs, dt, A, B_, C_, cfg.ssm_chunk)
    out["ssd_chunked_rows_independent"] = bool(torch.equal(y_s,
                                                           y_l[:, :S]))
    # the kernel alone on the chunk that holds row S - 1: zero rows after
    # S (as ssd_chunked pads a prefill) against the real rows
    Q = cfg.ssm_chunk
    c0 = (S - 1) // Q * Q
    n = S - c0

    def chunk(t, rows):
        t = t[:, c0:c0 + rows]
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, Q - rows))[:, None]

    ys, _ = ops.ssd_chunk(chunk(xs, n), chunk(dt, n), A, chunk(B_, n),
                          chunk(C_, n))
    rows = min(Q, L - c0)
    yl, _ = ops.ssd_chunk(chunk(xs, rows), chunk(dt, rows), A,
                          chunk(B_, rows), chunk(C_, rows))
    out["ssd_chunk_kernel_rows_independent"] = bool(torch.equal(
        ys[:, :, :n], yl[:, :, :n]))
    return out


def boundary(cs, cfg, params, prompts, want, device="cuda") -> dict:
    """The ``--boundary`` readings of one model (see the module doc)."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward, prefill
    from repro_torch.serving.kvcache import gather_tokens
    src, dst = cs.migration_engines(cfg, params, device, "reprefill",
                                    **cs.FULL_WIDTH_ENGINE, **cs.PAGED)
    cs.serve_part_way(src, {r: (p, 32) for r, p in enumerate(prompts)},
                      after=cs.MIGRATE_AFTER)
    cs.move_inflight(src, dst, "reprefill")
    while dst.waiting or any(r.prefilling for r in dst.active.values()):
        dst.step()
    per_request = []
    for s, r in sorted(dst.active.items(), key=lambda x: x[1].rid):
        ctx = np.asarray(r.ctx, np.int32)
        n = len(ctx)
        k_dst, v_dst = gather_tokens(dst.cache.pool, dst.cache.seq_blocks[s],
                                     n)
        logits, pc = prefill(params, cfg,
                             torch.from_numpy(ctx[None]).to(device))
        done = n - len(prompts[r.rid])       # tokens served before
        longer = np.concatenate([ctx, np.asarray(want[r.rid][done:31],
                                                 np.int32)])
        longer_t = torch.from_numpy(longer[None]).to(device)
        _, pl = prefill(params, cfg, longer_t)
        row = {"rid": r.rid, "context": n,
               "destination_equals_prefill": None}
        if cfg.has_attn:
            row["destination_equals_prefill"] = bool(
                torch.equal(k_dst, pc.k[:, 0]) and torch.equal(v_dst,
                                                               pc.v[:, 0]))
            row["k_vs_longer"] = _differ(pc.k[:, 0], pl.k[:, 0, :n])
            row["v_vs_longer"] = _differ(pc.v[:, 0], pl.v[:, 0, :n])
        # the context's last logits, against the forward over the longer
        full = forward(params, cfg, longer_t)
        row["last_logits_max_abs_diff"] = float(
            (logits[0] - full[0, n - 1]).abs().max())
        per_request.append(row)
        cs.log(f"{cfg.name} boundary request {r.rid}: {row}")
    del src, dst
    # B2 and one projection on random inputs at this model's shapes: do a
    # row's results depend on how many rows follow it?
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    S, extra = 900, 22
    q = torch.randn(1, S + extra, cfg.n_q_heads, cfg.head_dim,
                    generator=gen, device=device).bfloat16()
    kv = [torch.randn(1, S + extra, cfg.n_kv_heads, cfg.head_dim,
                      generator=gen, device=device).bfloat16()
          for _ in range(2)]
    short = ops.flash_attention(q[:, :S].contiguous(), kv[0][:, :S]
                                .contiguous(), kv[1][:, :S].contiguous())
    long_ = ops.flash_attention(q, kv[0], kv[1])
    x = torch.randn(1, S + extra, cfg.d_model, generator=gen,
                    device=device).bfloat16()
    w = params["blocks"]["attn"]["wq"][0]
    shapes = {"b2_rows_independent": bool(torch.equal(short,
                                                      long_[:, :S])),
              "projection_rows_independent": bool(torch.equal(
                  x[:, :S] @ w, (x @ w)[:, :S]))}
    from repro_torch.models.model import _block, _positions, layer_params
    bp = layer_params(params["blocks"], 0)
    shapes["layer_rows_independent"] = bool(torch.equal(
        _block(x[:, :S], bp, cfg, 0, _positions(1, S, x.device))[0],
        _block(x, bp, cfg, 0, _positions(1, S + extra, x.device))[0][:, :S]))
    if cfg.has_ssm:
        shapes.update(ssd_rows(cfg, params, x, S))
    cs.log(f"{cfg.name} row independence at S {S} vs {S + extra}: {shapes}")
    return {"requests": per_request, **shapes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--boundary", action="store_true",
                    help="the re-prefill's state against the forward's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("migrate_agreement: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    card = cs.card_line()
    out = {"card": card, "models": {}}
    for arch in ("hymba-1.5b", "yi-9b"):
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
        prompts = cs.full_width_prompts(cfg)
        fin, _, _ = cs.serve(cfg, params, prompts, 32, "cuda",
                             **cs.FULL_WIDTH_ENGINE, **cs.PAGED)
        want = {r: fin[r].generated for r in fin}
        if args.boundary:
            out["models"][arch] = boundary(cs, cfg, params, prompts, want)
            del params
            torch.cuda.empty_cache()
            continue

        def agreement(streams):
            per = [cs.teacher_forced_agreement(cfg, params, prompts[r],
                                               streams[r])
                   for r in sorted(streams)]
            return float(np.mean(per)), [round(a, 4) for a in per]

        rows = {"uninterrupted": agreement(want)}
        cs.log(f"{arch} uninterrupted: agreement {rows['uninterrupted']}")
        partings = []
        for path in ("handoff", "reprefill"):
            for after in POINTS:
                got = migrated(cs, cfg, params, prompts, path, after)
                mean, per = agreement(got)
                rows[f"{path}@{after}"] = (mean, per, got == want)
                cs.log(f"{arch} {path} after {after} tokens: agreement "
                       f"{mean:.4f} {per}; equal to uninterrupted "
                       f"{got == want}")
                if path == "reprefill" and after == cs.MIGRATE_AFTER + 1:
                    reprefilled = got
                    partings = [dict(rid=r, **parting(cfg, params,
                                                      prompts[r], want[r],
                                                      got[r]))
                                for r in sorted(got) if got[r] != want[r]]
        for name, streams in (("uninterrupted", want),
                              ("reprefill@9", reprefilled)):
            gaps = sorted(g for r in sorted(streams)
                          for g in flip_gaps(cfg, params, prompts[r],
                                             streams[r]))
            rows[f"flip_gaps {name}"] = gaps
            cs.log(f"{arch} {name}: {len(gaps)} tokens off the forward's "
                   f"argmax, logit gaps {gaps}")
        for p in partings:
            cs.log(f"{arch} re-prefill after {cs.MIGRATE_AFTER + 1} tokens, "
                   f"request {p['rid']}: parts at {p['position']}: "
                   f"uninterrupted {p['uninterrupted']} (logit "
                   f"{p['logit_uninterrupted']:.4f}) migrated "
                   f"{p['migrated']} ({p['logit_migrated']:.4f}), forward "
                   f"argmax {p['forward_argmax']} "
                   f"({p['logit_argmax']:.4f})")
        out["models"][arch] = {"agreement": rows, "partings": partings}
        del params
        torch.cuda.empty_cache()
    cs.log(card)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
