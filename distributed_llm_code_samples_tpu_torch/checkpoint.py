"""Checkpoint / resume, as in the JAX package's ``checkpoint.py``.

A checkpoint is ``(params, step, seed schedule)``: restoring it mid-run
continues the exact run (same data, same gradients, same final params as
an uninterrupted run), on the seeds-as-dataset design.

The on-disk format is JAX's, so a checkpoint written by either package
restores in the other:

- one directory a step, ``step_{N}/``, holding ``arrays.npz`` (backend
  ``npz``: every leaf keyed by its tree path) or ``<path>.raw`` a leaf
  (backend ``native``: the raw bytes, written by the async C++ writer
  ``native/ckpt_writer.cpp``), and ``meta.json`` with ``step``,
  ``backend``, ``leaf_names``, ``leaf_shapes``, ``leaf_dtypes``,
  ``checksums`` (CRC-32 of ``arrays.npz``, or of each ``.raw``),
  ``seeds`` and the caller's ``meta``;
- the tree paths are the names ``jax.tree_util.keystr`` gives the JAX
  counterpart of the tree: ``.w1`` for the FFN stack, ``.wte`` and
  ``.blocks.wq`` for ``LMParams``, ``[0].wte``, ``[1].mu.wte`` and
  ``[1].count`` for ``(params, AdamState)`` (``_named``);
- bf16 leaves are stored as their 2-byte words (``u2``) with
  ``"bfloat16"`` in ``leaf_dtypes``;
- a step is staged in ``step_{N}.tmp`` (native: ``step_{N}.tmp.<pid>.<n>``),
  its payload fsync'd, then published by ``os.rename`` with the directory
  fsync'd on both sides, so ``latest_step`` never sees a torn step; a
  restore with ``step=None`` takes the newest step that verifies
  (``latest_verified_step``).

Restore puts each leaf on the target leaf's device in its dtype (on the
card, straight onto CUDA tensors). The JAX package's ``orbax`` backend
(its multi-host library) is not ported and raises, as do its multi-host
barriers and its primary-process branches: the port's launchers are
single-controller, so the calling process is always the one that writes
(ROADMAP.md).
"""

from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import sys
import zlib
from typing import Any

import numpy as np
import torch

from .models.lm import LMParams
from .runtime.wire import crc_file, fsync_dir, fsync_file, np_dtype

_STEP_RE = re.compile(r"^step_(\d+)$")
BACKENDS = ("npz", "native")

# numpy's dtype names (which JAX writes) of the torch types a leaf takes
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


class CorruptCheckpointError(RuntimeError):
    """An explicitly requested checkpoint failed integrity verification."""


class NonFiniteParamsError(RuntimeError):
    """A training segment produced non-finite params (a poisoned step)."""


class LossSpikeError(RuntimeError):
    """A segment's param update jumped far beyond the previous segment's
    (the loss-spike signature). Recoverable: the supervisor's rollback
    rung rewinds to the last verified checkpoint in process
    (``runtime/failure.py``). ``baseline`` is the pre-spike update norm,
    so a retry keeps the reference scale."""

    def __init__(self, msg: str, baseline: float | None = None):
        super().__init__(msg)
        self.baseline = baseline


_ASYNC_WRITER = None
_ERRORS_SEEN = 0  # errors already reported by an earlier wait_pending
_TMP_SEQ = 0      # unique tmp-dir suffixes of the async staging


def _writer():
    """The process's native async checkpoint writer (lazy; 2 threads)."""
    global _ASYNC_WRITER
    if _ASYNC_WRITER is None:
        from .runtime.native import AsyncCheckpointWriter
        _ASYNC_WRITER = AsyncCheckpointWriter(n_threads=2)
    return _ASYNC_WRITER


def wait_pending() -> None:
    """Block until every ``backend="native"`` checkpoint this process
    submitted is published; raises if a write failed since the last
    wait."""
    global _ERRORS_SEEN
    if _ASYNC_WRITER is None:
        return
    _ASYNC_WRITER.wait()
    errs = _ASYNC_WRITER.errors()
    new = errs - _ERRORS_SEEN
    _ERRORS_SEEN = errs
    if new:
        raise RuntimeError(
            f"{new} async checkpoint write(s) failed "
            "(their step_*.tmp dirs are left behind for inspection)")


# -- trees --------------------------------------------------------------------

def _named(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(keystr path, tensor)`` of every leaf, in the JAX counterpart's
    ``tree_flatten_with_path`` order: tensors, None (no leaf), ``LMParams``
    (``.wte``, ``.wpe``, ``.blocks.<field>``, ``.ln_f``), the other
    containers with ``named_leaves`` (``TransformerParams``) and named
    tuples (``.<field>``), tuples and lists (``[i]``) and dicts (``['key']``,
    sorted)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, LMParams):
        return [p for f in ("wte", "wpe", "blocks", "ln_f")
                for p in _named(getattr(tree, f), f"{prefix}.{f}")]
    if hasattr(tree, "with_leaves"):    # TransformerParams: flat fields
        return [(f"{prefix}.{f}", t) for f, t in tree.named_leaves()]
    if hasattr(tree, "_fields"):
        return [p for f, v in zip(tree._fields, tree)
                for p in _named(v, f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _named(v, f"{prefix}[{i}]")]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _named(tree[k], f"{prefix}[{k!r}]")]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure over ``leaves`` (``{path: tensor}``)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return leaves[prefix]
    if isinstance(tree, LMParams):
        return LMParams(*(_rebuild(getattr(tree, f), leaves, f"{prefix}.{f}")
                          for f in ("wte", "wpe", "blocks", "ln_f")))
    if hasattr(tree, "with_leaves"):
        return tree.with_leaves([leaves[f"{prefix}.{f}"]
                                 for f, _ in tree.named_leaves()])
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves, f"{prefix}.{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return {k: _rebuild(tree[k], leaves, f"{prefix}[{k!r}]") for k in tree}


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _DTYPE_NAMES:
        raise ValueError(f"no checkpoint dtype name for {t.dtype}")
    return _DTYPE_NAMES[t.dtype]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy in an npz-safe dtype: bf16 as its ``u2`` words (numpy has
    no bf16; the true dtype travels in ``meta.json``), as JAX stores its
    ml_dtypes leaves."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    """A saved array (in its stored dtype) as a CPU tensor of dtype
    ``name``."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} has no torch type")
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.view(np_dtype(name)).copy())


def _n_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


# -- integrity ----------------------------------------------------------------

def verify_checkpoint(path: str) -> tuple[bool, str]:
    """Integrity-check one published ``step_{N}`` dir: ``meta.json``
    parses and every checksummed payload file matches its recorded
    CRC-32. A checkpoint without ``checksums`` verifies by file presence
    alone."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"meta.json unreadable: {type(e).__name__}: {e}"
    for fname, want in doc.get("checksums", {}).items():
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            return False, f"{fname} missing"
        got = crc_file(fpath)
        if got != want:
            return False, (f"{fname} checksum mismatch "
                           f"(crc32 {got:#010x} != recorded {want:#010x})")
    if doc.get("backend", "npz") == "npz" and "checksums" not in doc \
            and not os.path.exists(os.path.join(path, "arrays.npz")):
        return False, "arrays.npz missing"
    return True, "ok"


def _steps(ckpt_dir: str) -> list[int]:
    return [int(m.group(1)) for name in os.listdir(ckpt_dir)
            if (m := _STEP_RE.match(name))]


def latest_verified_step(ckpt_dir: str) -> int | None:
    """Highest published step that passes ``verify_checkpoint`` (the
    resume anchor); corrupt steps are skipped with a stderr note naming
    the damage."""
    if not os.path.isdir(ckpt_dir):
        return None
    for step in sorted(_steps(ckpt_dir), reverse=True):
        ok, reason = verify_checkpoint(os.path.join(ckpt_dir, f"step_{step}"))
        if ok:
            return step
        print(f"checkpoint: step_{step} failed verification ({reason}); "
              "falling back to an earlier step", file=sys.stderr)
    return None


def latest_step(ckpt_dir: str) -> int | None:
    """Highest published (not ``.tmp``) step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def read_meta(ckpt_dir: str, step: int) -> dict:
    """The caller's ``meta`` dict saved with ``step_{step}`` (empty when it
    carries none): the elastic resume reads ``data_shards`` from here."""
    try:
        with open(os.path.join(ckpt_dir, f"step_{step}", "meta.json")) as f:
            return json.load(f).get("meta", {}) or {}
    except (OSError, ValueError):
        return {}


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise ValueError("backend='orbax' is the JAX package's multi-host "
                         "library and is not ported (ROADMAP.md); use "
                         "'npz' or 'native'")
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         f"(one of {BACKENDS})")


# -- save and restore ---------------------------------------------------------

def save_checkpoint(ckpt_dir: str, params: Any, step: int, seeds=None,
                    meta: dict | None = None, backend: str = "npz") -> str:
    """Write ``step_{step}/`` atomically; returns the final path.
    ``params`` is any tree of tensors (on any device); ``seeds`` the whole
    seed schedule, so a resumed run replays the same data. With
    ``backend="native"`` the write runs on the C++ writer's threads and
    this returns once the buffers are copied (``wait_pending``)."""
    global _TMP_SEQ
    _check_backend(backend)
    named = _named(params)
    names = [n for n, _ in named]
    if backend == "native" and any("/" in n for n in names):
        raise ValueError("native backend writes one file per leaf; tree "
                         f"paths may not contain '/': {names}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if backend == "native":
        # a staging dir of its own per submit: a re-save of the same step
        # must not race a writer thread on the same tmp path
        _TMP_SEQ += 1
        tmp = f"{final}.tmp.{os.getpid()}.{_TMP_SEQ}"
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    host = [_to_numpy(t) for _, t in named]
    if backend == "npz":
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **dict(zip(names, host)))
        fsync_file(npz_path)     # durable before the publishing rename
        checksums = {"arrays.npz": crc_file(npz_path)}
    else:
        # the buffers the writer will write: the bytes on disk must equal
        # these or the restore-side verify rejects them
        checksums = {n + ".raw": zlib.crc32(a.tobytes())
                     for n, a in zip(names, host)}
    doc = {"step": int(step), "backend": backend, "leaf_names": names,
           "leaf_shapes": [list(t.shape) for _, t in named],
           "leaf_dtypes": [_dtype_name(t) for _, t in named],
           "checksums": checksums}
    if seeds is not None:
        doc["seeds"] = np.asarray(seeds).tolist()
    if meta:
        doc["meta"] = meta
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    if backend == "native":
        # re-publishing the same step drops the old version first
        if os.path.exists(final):
            shutil.rmtree(final)
        _writer().submit(tmp, final, names, host)
        return final
    fsync_dir(tmp)             # entries durable before they become visible
    old = None
    if os.path.exists(final):
        # keep the previous version valid until the new one is published
        old = final + ".old.tmp"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)      # atomic publish
    fsync_dir(ckpt_dir)        # the rename itself survives a crash
    if old is not None:
        shutil.rmtree(old)
    return final


def restore_checkpoint(ckpt_dir: str, target: Any, step: int | None = None,
                       verify: bool = True):
    """Restore ``(params, step, seeds)``. ``target`` is an example tree
    (the same structure, shapes and dtypes as saved, e.g. freshly
    initialized params); each restored leaf goes to its target leaf's
    device. ``step=None`` takes the newest step that verifies; an
    explicitly requested step that fails verification raises
    ``CorruptCheckpointError``. ``verify=False`` skips the CRC pass of a
    step the caller verified already."""
    wait_pending()     # a native save of this process may be in flight
    if step is None:
        step = latest_verified_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no verified checkpoint under {ckpt_dir}")
        verify = False  # just verified, byte for byte
    path = os.path.join(ckpt_dir, f"step_{step}")
    if verify:
        ok, reason = verify_checkpoint(path)
        if not ok:
            raise CorruptCheckpointError(f"{path}: {reason}")
    with open(os.path.join(path, "meta.json")) as f:
        doc = json.load(f)
    named = _named(target)
    names = [n for n, _ in named]
    if doc.get("leaf_names") != names:
        raise ValueError(
            f"checkpoint tree {doc.get('leaf_names')} != target tree {names}")
    saved_shapes = [tuple(s) for s in doc.get("leaf_shapes", [])]
    target_shapes = [tuple(t.shape) for _, t in named]
    if saved_shapes and saved_shapes != target_shapes:
        raise ValueError(
            f"checkpoint shapes {saved_shapes} != target shapes "
            f"{target_shapes} — the checkpoint is from a different model "
            "config (layers/model_size)")
    saved_dtypes = doc.get("leaf_dtypes", [])
    target_dtypes = [_dtype_name(t) for _, t in named]
    if saved_dtypes and saved_dtypes != target_dtypes:
        raise ValueError(
            f"checkpoint dtypes {saved_dtypes} != target dtypes "
            f"{target_dtypes} — resuming would silently continue in the "
            "saved dtype; re-init the run or match --dtype")
    dtypes = saved_dtypes or target_dtypes
    backend = doc.get("backend", "npz")
    _check_backend(backend)
    if backend == "native":
        arrays = [np.fromfile(os.path.join(path, n + ".raw"), np.uint8)
                  .view(np_dtype(dt)).reshape(shape)
                  for n, dt, shape in zip(names, dtypes, target_shapes)]
    else:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = [z[n] for n in names]
    leaves = {n: _from_numpy(a, dt).to(t.device)
              for (n, t), a, dt in zip(named, arrays, dtypes)}
    seeds = np.asarray(doc["seeds"], np.int32) if "seeds" in doc else None
    return _rebuild(target, leaves), int(doc["step"]), seeds


def tree_finite(tree) -> bool:
    """True iff every floating leaf of the tree is free of NaN and Inf
    (integer state, Adam's count, is always finite)."""
    return all(bool(torch.isfinite(t).all()) for _, t in _named(tree)
               if t.is_floating_point())


def _emit_event(on_event, payload: dict) -> None:
    if on_event is not None:
        try:
            on_event(payload)
        except Exception:  # noqa: BLE001 - observability never kills a run
            pass


def _prune_old_steps(ckpt_dir: str, keep_last: int) -> None:
    """Drop all but the newest ``keep_last`` published steps."""
    steps = sorted(_steps(ckpt_dir))
    for step in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{step}"),
                      ignore_errors=True)


def _accum_surface(train_fn) -> bool:
    """Whether ``train_fn`` takes ``seed_accum`` (or ``**kwargs``)."""
    try:
        ps = inspect.signature(train_fn).parameters
    except (TypeError, ValueError):
        return True
    return "seed_accum" in ps or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in ps.values())


# -- the segmented runner -----------------------------------------------------

def run_with_checkpointing(train_fn, params, seeds, *args,
                           ckpt_dir: str, every: int = 0, resume: bool = True,
                           backend: str = "npz", seeds_divisor: int = 1,
                           stateful: bool = False, optimizer=None,
                           thread_state: bool | None = None, chaos=None,
                           nonfinite: str | None = None, keep_last: int = 0,
                           on_event=None, guard=None, guard_state=None,
                           spike_factor: float = 0.0,
                           spike_baseline: float | None = None,
                           elastic: bool = True,
                           in_graph_chaos: bool = False, **kwargs):
    """Drive any trainer (``fn(params, seeds, batch, d, **kw)``) with
    periodic checkpointing, as JAX's ``run_with_checkpointing``.

    The schedule runs in ``every``-step segments (0: one segment); after
    each the params and the whole schedule are saved under
    ``step_{completed}``. On ``resume`` the latest verified checkpoint's
    params and schedule are authoritative; a longer schedule than the
    saved one extends the run. ``resume=False`` clears the ``step_*``
    dirs first. A fresh run publishes ``step_0``. ``every`` must be a
    multiple of ``seeds_divisor`` (the data-shard count of a strided
    trainer).

    With an ``optimizer`` and ``thread_state=True`` the checkpointed tree
    is ``(params, opt_state)`` and the state threads through the segments
    (``optimizer=``, ``opt_state=``, ``return_state=True`` to the
    trainer); without ``thread_state`` the optimizer goes straight to the
    trainer, and resuming a stateful rule's run from a step past 0 is
    refused.

    Resilience hooks (``runtime/chaos.py``, ``runtime/failure.py``):
    ``chaos`` (a ``FaultPlan``) wraps the trainer with its in-segment
    faults and fires its publish faults after each save; ``nonfinite``
    ``"skip"`` drops a segment whose result is not finite (never
    checkpointed) and ``"raise"`` raises ``NonFiniteParamsError``;
    ``guard`` threads the skip-step guard and its state through every
    segment and emits an ``anomaly`` event where its counters moved
    (``in_graph_chaos`` routes nan/inf faults through the seeds' poison
    bits, for the FFN family); ``spike_factor > 0`` raises
    ``LossSpikeError`` for a segment whose update norm exceeds that many
    times the previous segment's (``spike_baseline`` carries the
    pre-spike norm into a retry); ``keep_last`` keeps the newest k steps;
    ``on_event`` gets one dict a recovery event and a ``published`` event
    a segment.

    ``elastic``: a resume whose checkpoint was saved under N data shards
    onto M (``seeds_divisor``) re-strides the rest of the schedule. Scale
    up (N | M) continues on the new M-seed global batch; scale down (M |
    N) passes ``seed_accum = N / M`` to the trainer, which the port's
    trainers do not take yet (ROADMAP.md Queue 1 item 3.4). Every
    published step records ``data_shards`` and ``n_devices``."""
    _check_backend(backend)
    seeds = np.asarray(seeds)
    if seeds_divisor > 1:
        if every > 0 and every % seeds_divisor:
            raise ValueError(
                f"checkpoint every={every} must be a multiple of the "
                f"data-shard count {seeds_divisor}: each segment's seeds "
                "are split strided across the data axis")
        if len(seeds) % seeds_divisor:
            raise ValueError(
                f"{len(seeds)} seeds do not divide across "
                f"{seeds_divisor} data shards")
    thread = bool(thread_state)
    if optimizer is not None and not thread:
        kwargs["optimizer"] = optimizer
        stateful = stateful or not getattr(optimizer, "stateless", False)
        optimizer = None
    opt_state = optimizer.init(params) if optimizer is not None else None
    tree = (params, opt_state) if optimizer is not None else params

    start = 0
    wait_pending()     # flush in-flight native saves before reading state
    if resume and (agreed := latest_verified_step(ckpt_dir)) is not None:
        if stateful and optimizer is None and agreed > 0:
            raise ValueError(
                f"cannot resume a stateful-optimizer run from step "
                f"{agreed}: optimizer state is not checkpointed for this "
                "trainer; pass resume=False (--no_resume) to retrain from "
                "step 0, or use the stateless sgd optimizer")
        tree, start, saved = restore_checkpoint(ckpt_dir, tree, step=agreed,
                                                verify=False)
        if optimizer is not None:
            params, opt_state = tree
        else:
            params = tree
        if saved is not None and len(saved):
            if len(seeds) > len(saved):
                seeds = np.concatenate([saved, seeds[len(saved):]])
            else:
                seeds = saved  # the saved schedule is authoritative
        saved_shards = read_meta(ckpt_dir, agreed).get("data_shards")
        divisor = max(1, seeds_divisor)
        if saved_shards and saved_shards != divisor:
            if not elastic:
                raise ValueError(
                    f"checkpoint step_{agreed} was saved under "
                    f"{saved_shards} data shards but this run has "
                    f"{divisor} (elastic=False)")
            if saved_shards % divisor == 0:
                accum = saved_shards // divisor
                if not _accum_surface(train_fn):
                    raise ValueError(
                        f"elastic resume from {saved_shards} shards onto "
                        f"{divisor} needs {accum}-way seed accumulation, "
                        f"but {getattr(train_fn, '__name__', train_fn)} "
                        "has no seed_accum surface (ddp/fsdp have one)")
                kwargs["seed_accum"] = accum
                seeds_divisor = saved_shards  # the global batch kept
            elif divisor % saved_shards == 0:
                accum = 1  # scale-up: the new global batch takes over
                seeds_divisor = divisor
            else:
                raise ValueError(
                    f"elastic resume needs the save-time shard count "
                    f"({saved_shards}) and the current one ({divisor}) "
                    "to divide one another (M|N or N|M)")
            if every > 0 and every % seeds_divisor:
                raise ValueError(
                    f"checkpoint every={every} does not tile the "
                    f"{seeds_divisor}-seed global batch preserved by "
                    "the elastic resume")
            if len(seeds) % seeds_divisor:
                raise ValueError(
                    f"{len(seeds)} seeds do not divide across the "
                    f"{seeds_divisor}-seed elastic global batch")
            _emit_event(on_event, {
                "event": "elastic_resume", "step": start,
                "saved_shards": int(saved_shards),
                "current_shards": int(divisor),
                "seed_accum": int(accum), "n_devices": _n_devices()})
    else:
        if os.path.isdir(ckpt_dir):
            # restart: stale step_* dirs must not feed a later resume
            for name in os.listdir(ckpt_dir):
                if _STEP_RE.match(name):
                    shutil.rmtree(os.path.join(ckpt_dir, name))
        # step_0 keeps the schedule through a crash in segment 1
        save_checkpoint(ckpt_dir, tree, 0, seeds, backend=backend,
                        meta={"data_shards": int(max(1, seeds_divisor)),
                              "n_devices": _n_devices()})
    ckpt_meta = {"data_shards": int(max(1, seeds_divisor)),
                 "n_devices": _n_devices()}
    gstate = g_seen = None
    if guard is not None:
        from .runtime.guardrails import host_state, summarize
        gstate = host_state(guard_state, guard)
        g_seen = summarize(gstate)
        kwargs = dict(kwargs, guard=guard)
    prev_delta = spike_baseline
    total = len(seeds)
    chunk = every if every > 0 else total
    if chaos is not None:
        # publish faults fire only on a publish boundary; one off it would
        # silently never fire
        for f in getattr(chaos, "faults", ()):
            if f.kind in ("corrupt_ckpt", "kill") and (
                    f.step > total or (f.step % chunk and f.step != total)):
                raise ValueError(
                    f"--chaos {f.kind}@{f.step} can never fire: publish "
                    f"faults key on checkpoint publishes, which happen "
                    f"at steps {chunk}, {2 * chunk}, ... {total} "
                    f"(every={every}, {total} steps)")
    while start < total:
        n = min(chunk, total - start)
        fn = train_fn
        seg_seeds = seeds[start:start + n]
        if chaos is not None:
            chaos.begin_segment(start, n, in_graph=bool(in_graph_chaos)
                                and guard is not None)
            fn = chaos.wrap(train_fn)
            seg_seeds = chaos.poison_segment_seeds(seg_seeds)
        gkw = ({} if guard is None
               else {"guard_state": gstate, "return_guard": True})
        if optimizer is not None:
            out = fn(params, seg_seeds, *args, optimizer=optimizer,
                     opt_state=opt_state, return_state=True, **gkw, **kwargs)
        else:
            out = fn(params, seg_seeds, *args, **gkw, **kwargs)
        if guard is not None:
            out, gstate = out
        if optimizer is not None:
            new_params, new_opt = out
            tree = (new_params, new_opt)
        else:
            new_params, new_opt = out, None
            tree = new_params
        if guard is not None:
            from .runtime.guardrails import anomaly_delta, summarize
            cur = summarize(gstate)
            delta = anomaly_delta(g_seen, cur, start + n,
                                  [start + 1, start + n])
            if delta is not None:
                _emit_event(on_event, dict(delta, event="anomaly"))
            g_seen = cur
        if nonfinite and not tree_finite(tree):
            if nonfinite == "raise":
                err = NonFiniteParamsError(
                    f"non-finite params after steps "
                    f"{start + 1}..{start + n}")
                # the live guard state survives the rollback rung
                err.guard_state = gstate
                raise err
            print(f"checkpoint: non-finite params after steps "
                  f"{start + 1}..{start + n}; skipping the poisoned "
                  "segment (not checkpointed)", file=sys.stderr)
            _emit_event(on_event, {"event": "nonfinite_skip",
                                   "steps": [start + 1, start + n]})
            start += n
            continue
        if spike_factor > 0:
            from .runtime.guardrails import delta_norm
            delta = delta_norm(params, new_params)
            if (prev_delta is not None and prev_delta > 0
                    and delta > spike_factor * prev_delta):
                _emit_event(on_event, {
                    "event": "loss_spike", "steps": [start + 1, start + n],
                    "delta": round(delta, 6),
                    "baseline": round(prev_delta, 6),
                    "factor": spike_factor})
                err = LossSpikeError(
                    f"update norm {delta:.4g} after steps "
                    f"{start + 1}..{start + n} exceeds {spike_factor}x "
                    f"the previous segment's {prev_delta:.4g} — "
                    "loss-spike rollback", baseline=prev_delta)
                err.guard_state = gstate
                raise err
            prev_delta = delta
        params = new_params
        if optimizer is not None:
            opt_state = new_opt
        start += n
        # native: returns once the buffers are copied; the next segment
        # overlaps the disk write
        path = save_checkpoint(ckpt_dir, tree, start, seeds, backend=backend,
                               meta=ckpt_meta)
        _emit_event(on_event, {"event": "published", "step": start,
                               "steps": [start - n + 1, start]})
        if keep_last > 0:
            _prune_old_steps(ckpt_dir, keep_last)
        if chaos is not None:
            wait_pending()  # publish faults need the async write landed
            chaos.after_publish(start, path)
    wait_pending()  # durable on return, for the native backend too
    return params
