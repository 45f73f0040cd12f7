"""Train the LM on real text end to end and record its curves: the port of
the JAX package's root ``train_real_text.py``.

    python -m distributed_llm_code_samples_tpu_torch.train_real_text
    BENCH_PLATFORM=cpu TEXTLM_STEPS=40 TEXTLM_SEGMENTS=4 \\
        python -m distributed_llm_code_samples_tpu_torch.train_real_text

Corpus: the embedded real text (``data.load_text_corpus``), byte-level
vocabulary (256). The final ``TEXTLM_HOLDOUT`` share of the bytes (10%)
is held out: training windows start only inside the rest
(``data.text_batch_from_seed`` bounds starts by ``len - T``), and every
eval point reports the loss on a fixed batch of each split. The model is
``models/lm.py`` (pre-LN transformer, tied head, the hand-VJP oracle
attention and head, as JAX's script runs), trained by ``train_lm_single``
with ``scheduled(clipped(adamw(weight_decay=0.01), 1.0),
warmup_cosine(...))`` through its ``batch_fn`` hook, a segment at a time
with the optimizer state carried across. Every eval segment whose
held-out loss improves saves a checkpoint (``checkpoint.py``, ``native``
backend); after the run, ``wait_pending`` and a restore of the best step
give the params that sample the continuation (temperature 0.8, top-k 40,
seed 7) from the prompt ``"  GNU GENERAL PUBLIC LICENSE\\n"``.

The variables and defaults are JAX's: ``TEXTLM_D`` 256,
``TEXTLM_LAYERS`` 4, ``TEXTLM_HEADS`` 8, ``TEXTLM_SEQ`` 256,
``TEXTLM_BATCH`` 32, ``TEXTLM_STEPS`` 1000, ``TEXTLM_SEGMENTS`` 10,
``TEXTLM_LR`` 1e-3, ``TEXTLM_HOLDOUT`` 0.10, ``TEXTLM_CKPT_DIR`` (kept;
otherwise a temporary directory removed at the end). It prints one JSON
line an eval point, ``{"step", "train_loss", "holdout_loss"}``, then the
final payload with JAX's keys, also written to ``TEXTLM_ARTIFACT``
(default ``TEXTLM_torch.json``). It runs on the card; ``BENCH_PLATFORM=cpu``
asks for the CPU, and without a card and without it, it raises.

``train_text`` is the loop, given the params and the ``batch_fn``, so a
test can start it from JAX's init and feed it JAX's windows.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

VOCAB = 256
PROMPT = "  GNU GENERAL PUBLIC LICENSE\n"
EVAL_SEEDS = (999_983, 999_979)   # the training split's and the tail's


def config() -> dict:
    """The run's shape from the ``TEXTLM_*`` variables (JAX's defaults)."""
    env = os.environ.get
    return dict(d=int(env("TEXTLM_D", 256)),
                layers=int(env("TEXTLM_LAYERS", 4)),
                heads=int(env("TEXTLM_HEADS", 8)),
                seq=int(env("TEXTLM_SEQ", 256)),
                batch=int(env("TEXTLM_BATCH", 32)),
                steps=int(env("TEXTLM_STEPS", 1000)),
                segments=int(env("TEXTLM_SEGMENTS", 10)),
                lr=float(env("TEXTLM_LR", 1e-3)),
                holdout=float(env("TEXTLM_HOLDOUT", 0.10)),
                artifact=env("TEXTLM_ARTIFACT", "TEXTLM_torch.json"),
                ckpt_dir=env("TEXTLM_CKPT_DIR"))


def split_corpus(corpus: np.ndarray, holdout: float, seq: int):
    """``(train bytes, held-out bytes)``: the tail share is never sampled
    by the training windows."""
    split = int(corpus.shape[0] * (1.0 - holdout))
    train, held = corpus[:split], corpus[split:]
    if held.shape[0] < seq + 1:
        raise SystemExit(f"held-out tail ({held.shape[0]} bytes) shorter "
                         f"than one {seq + 1}-byte window")
    return train, held


def optimizer(lr: float, steps: int):
    """JAX's script's rule: clipped AdamW under warmup-cosine."""
    from .optim import adamw, clipped, scheduled, warmup_cosine
    return scheduled(clipped(adamw(weight_decay=0.01), 1.0),
                     warmup_cosine(lr, max(steps // 20, 1), steps))


def train_text(params, batch_fn, evals, *, steps: int, segments: int,
               batch: int, seq: int, heads: int, lr: float, ckpt_dir: str,
               on_point=None) -> dict:
    """The real-text loop: ``segments`` calls of ``train_lm_single`` of
    ``steps // segments`` steps (the seed is the step index), an eval
    point after each (``evals``: the ``(tokens, targets)`` of the training
    split's and the held-out eval batch), a native checkpoint of each
    point that improves the held-out loss, then ``wait_pending`` and the
    restore of the best step. ``on_point(point, params)`` sees each
    point. Returns ``curve``, ``best`` (its point), ``best_params``,
    ``best_step`` and ``train_s``."""
    from .checkpoint import restore_checkpoint, save_checkpoint, wait_pending
    from .models.lm import lm_loss
    from .parallel.lm import train_lm_single
    dev = params.device
    evals = [(t.to(dev), g.to(dev)) for t, g in evals]
    opt = optimizer(lr, steps)

    @torch.no_grad()
    def eval_point(p, step):
        tr, ho = (float(lm_loss(p, t, g, heads)) for t, g in evals)
        return {"step": step, "train_loss": round(tr, 4),
                "holdout_loss": round(ho, 4)}

    def emit(point, p):
        print(json.dumps(point), flush=True)
        if on_point is not None:
            on_point(point, p)

    per_seg = steps // segments
    state = None
    curve = [eval_point(params, 0)]
    emit(curve[0], params)
    best = {"holdout_loss": float("inf"), "step": 0}
    t0 = time.perf_counter()
    for seg in range(segments):
        seeds = np.arange(seg * per_seg, (seg + 1) * per_seg, dtype=np.int32)
        params, state = train_lm_single(
            params, seeds, batch * seq, params.d_model, lr=lr, seq_len=seq,
            n_heads=heads, optimizer=opt, opt_state=state,
            return_state=True, batch_fn=batch_fn)
        point = eval_point(params, (seg + 1) * per_seg)
        curve.append(point)
        emit(point, params)
        if point["holdout_loss"] < best["holdout_loss"]:
            best = dict(point)
            save_checkpoint(ckpt_dir, params, step=point["step"],
                            backend="native",
                            meta={"holdout_loss": point["holdout_loss"]})
    train_s = time.perf_counter() - t0  # the eval reads fence each segment
    wait_pending()
    best_params, best_step, _ = restore_checkpoint(ckpt_dir, params,
                                                   step=best["step"])
    return dict(curve=curve, best=best, best_params=best_params,
                best_step=best_step, train_s=train_s)


def main() -> int:
    from . import resolve_device
    from .data import load_text_corpus, text_batch_from_seed
    from .models import init_lm, lm_from_leaves, lm_leaves
    from .models.lm import sample
    cfg = config()
    device = resolve_device(
        "cpu" if os.environ.get("BENCH_PLATFORM") == "cpu" else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    d, seq, b, heads = cfg["d"], cfg["seq"], cfg["batch"], cfg["heads"]
    corpus = load_text_corpus()
    train, held = split_corpus(corpus, cfg["holdout"], seq)
    gen = torch.Generator().manual_seed(0)
    params = init_lm(gen, VOCAB, d, cfg["layers"], max_seq_len=seq,
                     n_heads=heads)
    params = lm_from_leaves(t.to(device) for t in lm_leaves(params))

    def batch_fn(seed):
        return text_batch_from_seed(seed, b, seq, corpus=train)

    evals = (text_batch_from_seed(EVAL_SEEDS[0], b, seq, corpus=train),
             text_batch_from_seed(EVAL_SEEDS[1], b, seq, corpus=held))
    user_dir = cfg["ckpt_dir"]
    ckpt_dir = user_dir or tempfile.mkdtemp(prefix="textlm_best_ckpt_")
    try:
        run = train_text(params, batch_fn, evals, steps=cfg["steps"],
                         segments=cfg["segments"], batch=b, seq=seq,
                         heads=heads, lr=cfg["lr"], ckpt_dir=ckpt_dir)
    finally:
        if not user_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    prompt = torch.tensor([list(PROMPT.encode())])
    n_new = min(200, seq - prompt.shape[1])  # the cache holds max_seq_len
    out = sample(run["best_params"], prompt, n_new, heads, temperature=0.8,
                 top_k=40, seed=7)
    continuation = bytes(int(x) for x in out[0].cpu()).decode(
        "utf-8", errors="replace")
    curve, best, steps = run["curve"], run["best"], cfg["steps"]
    payload = {
        "metric": "real_text_lm_best_holdout_loss",
        "value": best["holdout_loss"],
        "unit": "nats/byte",
        "best_step": int(run["best_step"]),
        "best_train_loss": best["train_loss"],
        "final_holdout_loss": curve[-1]["holdout_loss"],
        "final_train_loss": curve[-1]["train_loss"],
        "generalization_gap": round(best["holdout_loss"]
                                    - best["train_loss"], 4),
        "initial_holdout_loss": curve[0]["holdout_loss"],
        "uniform_loss": round(math.log(float(VOCAB)), 4),
        "loss_curve": curve,
        "corpus_bytes": int(corpus.shape[0]),
        "train_bytes": int(train.shape[0]),
        "holdout_bytes": int(held.shape[0]),
        "schedule": f"warmup_cosine(peak={cfg['lr']}, "
                    f"warmup={max(steps // 20, 1)}, total={steps})",
        "shape": f"d{d}_L{cfg['layers']}_H{heads}_T{seq}_B{b}_steps{steps}",
        "tokens_per_sec": round(steps * b * seq / run["train_s"], 1),
        "train_seconds": round(run["train_s"], 2),
        "sample": continuation,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(payload), flush=True)
    with open(cfg["artifact"], "w") as f:
        json.dump(payload, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
