"""The port's checkpoint format against the JAX package's, on the CPU.

A checkpoint written by either package's ``save_checkpoint`` restores in
the other bit for bit, on both backends (``npz``, ``native``), for the
FFN stack, the LM and ``(LM params, AdamW state)``, in f32 and bf16: the
same ``leaf_names`` (JAX's ``keystr`` paths), shapes, dtype names,
checksums and layout. ``verify_checkpoint`` and ``latest_verified_step``
give the same answers on the same directories, torn ones included; the
tree, shape and dtype mismatches raise JAX's messages; ``keep_last``,
``resume=False`` and leftover ``.tmp`` dirs leave the same steps; a failed
native write raises from ``wait_pending``; orbax is refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import checkpoint as jck
from distributed_llm_code_samples_tpu.models import init_ffn_stack, init_lm
from distributed_llm_code_samples_tpu.optim import adamw as j_adamw
from distributed_llm_code_samples_tpu.runtime.chaos import (
    truncate_checkpoint as j_truncate)
from distributed_llm_code_samples_tpu_torch import checkpoint as ck
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.optim import AdamState
from distributed_llm_code_samples_tpu_torch.runtime.chaos import (
    truncate_checkpoint)
from torch_serve_refs import one_thread  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("one_thread")

SEEDS = np.array([3, 1, 4, 1, 5], np.int32)


def _jax_tree(kind, dtype):
    if kind == "ffn":
        tree = init_ffn_stack(jax.random.PRNGKey(0), 16, 2)
    else:
        tree = init_lm(jax.random.PRNGKey(1), 64, 16, 2, max_seq_len=8)
        if kind == "lm_adamw":
            state = j_adamw().init(tree)
            # moments that are not all zero, so their bits are checked
            state = state._replace(
                mu=jax.tree_util.tree_map(lambda p: p * 0.5, state.mu),
                nu=jax.tree_util.tree_map(lambda p: p * p, tree),
                count=jnp.int32(3))
            tree = (tree, state)
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _port_tree(kind, jtree):
    """The port's counterpart of ``jtree``, leaf for leaf (bf16 bits kept)."""
    if kind == "ffn":
        return ffn_params_from_numpy(jtree)
    if kind == "lm":
        return lm_params_from_numpy(jtree)
    params, state = jtree
    return (lm_params_from_numpy(params),
            AdamState(mu=lm_params_from_numpy(state.mu),
                      nu=lm_params_from_numpy(state.nu),
                      count=torch.from_numpy(np.array(state.count))))


def _bits(a) -> np.ndarray:
    """A leaf's raw words (bf16 as u2), for bit-for-bit comparisons."""
    if isinstance(a, torch.Tensor):
        return ck._to_numpy(a)
    return jck._to_numpy(a)


def _assert_same(jtree, ptree):
    jnames, jleaves, _ = jck._flatten(jtree)
    named = ck._named(ptree)
    assert [n for n, _ in named] == jnames
    for (n, p), j in zip(named, jleaves):
        assert str(np.asarray(j).dtype) == ck._dtype_name(p), n
        assert tuple(p.shape) == np.shape(j), n
        np.testing.assert_array_equal(_bits(p), _bits(j), err_msg=n)


CASES = [(k, d, b) for k in ("ffn", "lm", "lm_adamw")
         for d in ("float32", "bfloat16") for b in ("npz", "native")]


@pytest.mark.parametrize("kind,dtype,backend", CASES,
                         ids=[f"{k}-{d}-{b}" for k, d, b in CASES])
def test_checkpoints_restore_across_packages(tmp_path, kind, dtype, backend):
    """JAX saves, the port restores, and the other way round: same step,
    seeds, meta and leaves, bit for bit; the two ``meta.json`` agree on
    every key but the checksum of ``arrays.npz`` (its zip entries carry
    the write time)."""
    jtree = _jax_tree(kind, getattr(jnp, dtype))
    ptree = _port_tree(kind, jtree)
    _assert_same(jtree, ptree)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, jtree, 7, SEEDS, meta={"data_shards": 1},
                        backend=backend)
    jck.wait_pending()
    ck.save_checkpoint(pdir, ptree, 7, SEEDS, meta={"data_shards": 1},
                       backend=backend)
    ck.wait_pending()
    docs = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "step_7", "meta.json")) as f:
            docs.append(json.load(f))
        assert sorted(os.listdir(os.path.join(d, "step_7"))) == sorted(
            os.listdir(os.path.join(jdir, "step_7")))
    if backend == "npz":
        for doc in docs:
            doc.pop("checksums")
    assert docs[0] == docs[1]
    got, step, seeds = ck.restore_checkpoint(jdir, ptree)
    assert step == 7 and seeds.tolist() == SEEDS.tolist()
    _assert_same(jtree, got)
    back, step, seeds = jck.restore_checkpoint(pdir, jtree)
    assert step == 7 and np.asarray(seeds).tolist() == SEEDS.tolist()
    _assert_same(back, ptree)
    assert ck.read_meta(jdir, 7) == jck.read_meta(pdir, 7) == {
        "data_shards": 1}


def _tear(path, how):
    if how == "truncate":
        truncate_checkpoint(path)
    elif how == "meta":
        os.remove(os.path.join(path, "meta.json"))
    elif how == "flip":
        name = sorted(f for f in os.listdir(path) if f != "meta.json")[0]
        with open(os.path.join(path, name), "r+b") as f:
            f.seek(os.path.getsize(os.path.join(path, name)) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("backend", ["npz", "native"])
def test_verification_agrees_across_packages(tmp_path, backend):
    """Steps 1-4 written alternately by JAX and the port; step 4 torn,
    then step 3, then step 2, each in another way: both packages verify
    each step alike (the same reasons) and fall back to the same step."""
    jtree = _jax_tree("ffn", jnp.float32)
    ptree = _port_tree("ffn", jtree)
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        if step % 2:
            jck.save_checkpoint(d, jtree, step, backend=backend)
            jck.wait_pending()
        else:
            ck.save_checkpoint(d, ptree, step, backend=backend)
            ck.wait_pending()
    os.makedirs(os.path.join(d, "step_9.tmp"))    # a crash mid-write
    assert ck.latest_step(d) == jck.latest_step(d) == 4
    for torn, how in ((4, "truncate"), (3, "flip"), (2, "meta")):
        want_step = jck.latest_verified_step(d)
        assert ck.latest_verified_step(d) == want_step
        for step in (1, 2, 3, 4):
            path = os.path.join(d, f"step_{step}")
            assert ck.verify_checkpoint(path) == jck.verify_checkpoint(path)
        _tear(os.path.join(d, f"step_{torn}"), how)
        assert not ck.verify_checkpoint(os.path.join(d, f"step_{torn}"))[0]
    assert ck.latest_verified_step(d) == jck.latest_verified_step(d) == 1
    with pytest.raises(ck.CorruptCheckpointError, match="step_4"):
        ck.restore_checkpoint(d, ptree, step=4)
    got, step, _ = ck.restore_checkpoint(d, ptree)
    assert step == 1
    _assert_same(jtree, got)


def test_truncate_targets_the_same_file(tmp_path):
    """Both packages' ``truncate_checkpoint`` damage the same file of a
    native step (the first ``.raw`` in sorted order) and of an npz step."""
    ptree = _port_tree("lm", _jax_tree("lm", jnp.float32))
    for backend in ("npz", "native"):
        paths = []
        for name, trunc in (("a", truncate_checkpoint), ("b", j_truncate)):
            path = ck.save_checkpoint(str(tmp_path / backend / name), ptree,
                                      1, backend=backend)
            ck.wait_pending()
            paths.append(os.path.basename(trunc(path)))
        assert paths[0] == paths[1]


@pytest.mark.parametrize("mismatch", ["tree", "shape", "dtype"])
def test_mismatch_errors_match_jax(tmp_path, mismatch):
    """A restore into another tree, shape or dtype raises JAX's
    ``ValueError`` with JAX's message, whichever package wrote it."""
    saved = _jax_tree("ffn", jnp.float32)
    target = {"tree": _jax_tree("lm", jnp.float32),
              "shape": init_ffn_stack(jax.random.PRNGKey(0), 32, 2),
              "dtype": _jax_tree("ffn", jnp.bfloat16)}[mismatch]
    d = str(tmp_path)
    jck.save_checkpoint(d, saved, 1)
    with pytest.raises(ValueError) as jerr:
        jck.restore_checkpoint(d, target)
    with pytest.raises(ValueError) as perr:
        ck.restore_checkpoint(d, _port_tree(
            "lm" if mismatch == "tree" else "ffn", target))
    assert str(perr.value) == str(jerr.value)


def _bump(p, s, *args, **kw):
    """A trainer that adds the segment's length to every leaf (cheap, and
    the same arithmetic in both packages)."""
    if isinstance(p, torch.Tensor) or hasattr(p, "_fields") and isinstance(
            p[0], torch.Tensor):
        return type(p)(*(t + len(s) for t in p))
    return jax.tree_util.tree_map(lambda t: t + len(s), p)


def _steps(d):
    return sorted(n for n in os.listdir(d) if n.startswith("step_"))


def test_keep_last_no_resume_and_tmp_dirs_match_jax(tmp_path):
    """``keep_last=2`` leaves the same two steps as JAX's; a later run with
    ``resume=False`` clears them and starts from step 0 as JAX's does, a
    ``.tmp`` dir left beside them is never taken for a step, and a resume
    continues from the newest step in both, to the same bits."""
    jtree = _jax_tree("ffn", jnp.float32)
    ptree = _port_tree("ffn", jtree)
    seeds = np.arange(6, dtype=np.int32)
    dirs, outs = {}, {}
    for who, run, tree in (("jax", jck.run_with_checkpointing, jtree),
                           ("port", ck.run_with_checkpointing, ptree)):
        d = dirs[who] = str(tmp_path / who)
        run(_bump, tree, seeds, ckpt_dir=d, every=2, keep_last=2)
        assert _steps(d) == ["step_4", "step_6"]
        os.makedirs(os.path.join(d, "step_8.tmp"))
        out = run(_bump, tree, seeds[:4], ckpt_dir=d, every=2, resume=False)
        assert _steps(d) == ["step_0", "step_2", "step_4", "step_8.tmp"]
        out = run(_bump, tree, seeds, ckpt_dir=d, every=2)
        assert _steps(d) == ["step_0", "step_2", "step_4", "step_6",
                             "step_8.tmp"]
        outs[who] = _bits(out[0])
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    for step in (0, 2, 4, 6):
        with open(os.path.join(dirs["jax"], f"step_{step}",
                               "meta.json")) as f:
            j = json.load(f)
        with open(os.path.join(dirs["port"], f"step_{step}",
                               "meta.json")) as f:
            p = json.load(f)
        j.pop("checksums"), p.pop("checksums")
        # JAX counts its 8 virtual CPU devices, the port 1 (no card)
        assert (j["meta"].pop("n_devices"), p["meta"].pop("n_devices")) == (
            jax.device_count(), 1)
        assert p == j


def test_wait_pending_raises_on_a_failed_native_write(tmp_path):
    """A native write that cannot land (its staging dir's parent is a
    file) raises from the next ``wait_pending``, once; a later good save
    publishes and restores."""
    ptree = _port_tree("ffn", _jax_tree("ffn", jnp.float32))
    blocker = tmp_path / "file"
    blocker.write_text("")
    ck._writer().submit(str(blocker / "x.tmp"), str(blocker / "x"),
                        [".w1"], [np.zeros(4, np.float32)])
    with pytest.raises(RuntimeError, match="1 async checkpoint write"):
        ck.wait_pending()
    ck.wait_pending()              # reported once
    ck.save_checkpoint(str(tmp_path / "ok"), ptree, 2, backend="native")
    got, step, _ = ck.restore_checkpoint(str(tmp_path / "ok"), ptree)
    assert step == 2 and torch.equal(got.w1, ptree.w1)


def test_orbax_and_unknown_backends_raise(tmp_path):
    ptree = _port_tree("ffn", _jax_tree("ffn", jnp.float32))
    with pytest.raises(ValueError, match="orbax.*ROADMAP"):
        ck.save_checkpoint(str(tmp_path), ptree, 1, backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ck.run_with_checkpointing(_bump, ptree, SEEDS,
                                  ckpt_dir=str(tmp_path), backend="zarr")
    with pytest.raises(ValueError, match="native backend"):
        ck.save_checkpoint(str(tmp_path), {"a/b": torch.zeros(2)}, 1,
                           backend="native")
