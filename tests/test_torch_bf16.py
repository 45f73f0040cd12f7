"""``--dtype bfloat16`` for the FFN stack on one device: the parameters
carried across in bf16, the plain versions of the three FFN kernels and
the matmul blocks on bf16 against the JAX package's (its Pallas kernels
in interpret mode), SGD's rounding, ``train_single`` with and without
the kernels' blocks against JAX's, and the CLI (``-m 0`` on four gloo
ranks, the refusals, ``--dtype float32``).

Inputs are made from seeds with numpy (or by JAX's own ``init_ffn_stack``
and ``batch_from_seed``) and handed to both sides bit for bit. Rows are
T = 40 and T = 64 tokens: 40 is not a multiple of a CPU vector, where
torch's bf16 kernels have rounded differently before.

Tolerance is in bf16 steps: the step of an element is the spacing of
bf16 numbers at the larger magnitude of the two values (2^-7 of its
binade). Both sides sum bf16 products in f32 in their own orders and
round once, so an element may land one step away; the tests state the
share of elements that may do so.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.ops import ffn as j_ffn
from distributed_llm_code_samples_tpu.ops import pallas_ffn as j_pf
from distributed_llm_code_samples_tpu.optim import sgd as j_sgd
from distributed_llm_code_samples_tpu.parallel import train_single as j_single
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    tensor_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import ffn as p_ffn
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as p_ff
from distributed_llm_code_samples_tpu_torch.optim import sgd as p_sgd
from distributed_llm_code_samples_tpu_torch.parallel import train_single

BF = jnp.bfloat16
D, F, L, LR = 32, 128, 2, 0.1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16_steps(got, want):
    """``(max steps, share of elements that differ)`` of ``got`` (a
    tensor) against ``want`` (a tensor, or a JAX or numpy array) in bf16
    steps."""
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want).astype(np.float64)
    m = np.maximum(np.abs(g), np.abs(w))
    _, e = np.frexp(np.where(m > 0, m, 1.0))
    steps = np.abs(g - w) / np.ldexp(1.0, e - 8)
    return float(steps.max()), float((g != w).mean())


def bits(t):
    return t.view(torch.int16).numpy()


def jbits(a):
    return np.asarray(a).view(np.int16)


def _case(t, seed):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(0.02 * rng.normal(size=(F, D)), BF),
            jnp.asarray(0.02 * rng.normal(size=(D, F)), BF),
            jnp.asarray(rng.normal(size=(t, D)), BF),
            jnp.asarray(0.1 * rng.normal(size=(t, D)), BF))


def _port(*arrays):
    return [tensor_from_numpy(np.asarray(a)) for a in arrays]


# -- the parameters carried across ---------------------------------------

def test_params_from_numpy_keep_bf16_bits_both_ways():
    """JAX's bf16 ``init_ffn_stack`` reaches the port as bf16 with every
    bit, and goes back (widened exactly to f32, cast to bf16) with every
    bit; f32 params stay f32."""
    jp = init_ffn_stack(jax.random.PRNGKey(3), D, L, dtype=BF)
    p = ffn_params_from_numpy(jp)
    for t, a in zip(p, jp):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(bits(t), jbits(a))
        back = jnp.asarray(t.float().numpy()).astype(BF)
        np.testing.assert_array_equal(jbits(back), jbits(a))
    f32 = ffn_params_from_numpy(init_ffn_stack(jax.random.PRNGKey(3), D, L))
    assert f32.w1.dtype == torch.float32


# -- the plain FFN kernels and blocks -------------------------------------

@pytest.mark.parametrize("t", [40, 64])
@pytest.mark.parametrize("kernel", ["fwd", "dx", "dw"])
def test_plain_ffn_kernels_on_bf16_match_pallas_interpret(kernel, t):
    """``ffn_*_ref`` on bf16 (what the wrappers run on CPU tensors)
    against ``ffn_*_pallas(interpret=True)`` on bf16: bf16 outputs, each
    element equal to JAX's or one step away, at most 1% of them."""
    w1, w2, x, dy = _case(t, t)
    pw1, pw2, px, pdy = _port(w1, w2, x, dy)
    if kernel == "fwd":
        got = (p_ff.ffn_fwd_fused(pw1, pw2, px),)
        want = (j_pf.ffn_fwd_pallas(w1, w2, x, interpret=True),)
    elif kernel == "dx":
        got = (p_ff.ffn_bwd_dx_fused(pdy, pw1, pw2, px),)
        want = (j_pf.ffn_bwd_dx_pallas(dy, w1, w2, x, interpret=True),)
    else:
        got = p_ff.ffn_bwd_dw_fused(pdy, pw1, pw2, px)
        want = j_pf.ffn_bwd_dw_pallas(dy, w1, w2, x, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        most, share = bf16_steps(g, w)
        assert most <= 1 and share <= 0.01, (most, share)


def test_plain_ffn_kernels_round_the_hidden_activation():
    """The control: the same block with the hidden activation kept in f32
    (only the output rounded) is further from JAX's than the plain
    version, so the test above tells the two apart."""
    w1, w2, x, _ = _case(64, 5)
    pw1, pw2, px = _port(w1, w2, x)
    want = j_pf.ffn_fwd_pallas(w1, w2, x, interpret=True)
    h = px.float() @ pw1.float().T
    unrounded = (torch.relu(h) @ pw2.float().T).bfloat16()
    assert bf16_steps(unrounded, want)[1] > \
        bf16_steps(p_ff.ffn_fwd_ref(pw1, pw2, px), want)[1] + 0.01


@pytest.mark.parametrize("t", [40, 64])
def test_plain_blocks_on_bf16_match_jax(t):
    """``ops.ffn``'s forward and hand backward on bf16 tensors against
    JAX's on bf16 arrays (every product rounded to bf16, as XLA's bf16
    dot is): within one step, at most 1% of the elements."""
    w1, w2, x, dy = _case(t, 100 + t)
    pw1, pw2, px, pdy = _port(w1, w2, x, dy)
    got = (p_ffn.ffn_fwd(pw1, pw2, px),) + tuple(
        v for part in p_ffn.ffn_bwd(pdy, pw1, pw2, px)
        for v in (part if isinstance(part, tuple) else (part,)))
    want = (j_ffn.ffn_fwd(w1, w2, x),) + tuple(
        v for part in j_ffn.ffn_bwd(dy, w1, w2, x)
        for v in (part if isinstance(part, tuple) else (part,)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        most, share = bf16_steps(g, w)
        assert most <= 1 and share <= 0.01, (most, share)


# -- SGD ------------------------------------------------------------------

@pytest.mark.parametrize("lr", [0.1, 0.3, 1e-5])
def test_sgd_on_bf16_rounds_as_jax_does(lr):
    """``p - lr * g`` on bf16: JAX's weak-typed ``lr`` takes bf16 first,
    then ``lr * g`` is rounded to bf16 and subtracted. Bit for bit; the
    control (``lr`` kept in f32) differs at lr 0.1."""
    rng = np.random.default_rng(11)
    p = jnp.asarray(0.02 * rng.normal(size=(40, 96)), BF)
    g = jnp.asarray(0.01 * rng.normal(size=(40, 96)), BF)
    want = j_sgd([p], [g], lr)[0]
    tp, tg = _port(p, g)
    got = p_sgd([tp.clone()], [tg], lr)[0]
    np.testing.assert_array_equal(bits(got), jbits(want))
    if lr == 0.1:
        control = tp - tg.float().mul(lr).bfloat16()
        assert (bits(control) != jbits(want)).any()


# -- train_single ---------------------------------------------------------

@pytest.fixture(scope="module")
def single_setup():
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L, dtype=BF)
    seeds = np.asarray(make_seed_schedule(3, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), 40, D))
                        for s in seeds})
    return params, seeds, table


@pytest.mark.parametrize("pallas,accum", [(True, 1), (False, 1),
                                          (False, 2)])
def test_train_single_on_bf16_matches_jax(single_setup, pallas, accum):
    """Three steps of 40 tokens at lr 0.1 from JAX's bf16 params and on
    JAX's batches: through the kernels' blocks (their plain versions)
    against JAX's ``use_pallas=True, interpret=True``, and through the
    matmul blocks (also with two accumulation chunks) against JAX's
    plain trainer. bf16 params out, within 2 steps of JAX's, at most 2%
    of the elements; the run moved the weights by many steps."""
    params, seeds, table = single_setup
    start = ffn_params_from_numpy(params)
    got = train_single(start, seeds, 40, D, lr=LR, use_pallas=pallas,
                       accum=accum, batch_fn=table)
    kw = dict(use_pallas=True, interpret=True) if pallas else {}
    want = j_single(params, jnp.asarray(seeds), 40, D, lr=LR, accum=accum,
                    **kw)
    for g, w, s in zip(got, want, start):
        assert g.dtype == torch.bfloat16
        most, share = bf16_steps(g, w)
        assert most <= 2 and share <= 0.02, (most, share)
        assert bf16_steps(g, s)[1] > 0.5       # most weights moved


# -- the CLI --------------------------------------------------------------

def _cli(module, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})))


TINY = ("--fake_devices", "4", "-s", "8", "-bs", "2", "-n", "16", "-l", "2",
        "-d", "32", "-r", "7", "--dtype", "bfloat16")


def _verdicts(stdout):
    """The leaves each ``SoftAssertionError`` line names."""
    return sorted(line.split(" max|")[0].split(": ", 1)[1]
                  for line in stdout.splitlines()
                  if line.startswith("SoftAssertionError"))


def test_cli_method_0_in_bf16_reports_its_checks():
    """``-m 0 --dtype bfloat16 --strict`` on four ranks under the ring
    transport at lr 0.1: methods 1-4 run in bf16 (params, payload) and
    the checks run at JAX's f32 tolerances, as JAX's CLI runs them. DDP
    and FSDP sum in two ring orders, each add rounded to bf16, so DDP
    against FSDP disagrees by a step or two, as it does in JAX's CLI
    (``test_torch_train_bf16.py`` holds JAX's DDP and FSDP to the same
    check), and ``--strict`` exits 1. TP against single-device disagrees
    too: TP sums bf16 partial products over the ranks (JAX's CLI on the
    CPU passes that check, because XLA's CPU all-reduce carries bf16
    partial sums in f32)."""
    port = _cli("distributed_llm_code_samples_tpu_torch.cli", *TINY,
                "--device", "cpu", "--comm", "pallas_ring", "--lr", "0.1",
                "--strict")
    assert port.returncode == 1, port.stderr[-2000:]
    runs = [json.loads(l) for l in port.stdout.splitlines()
            if l.startswith("{")]
    assert [r["method"] for r in runs] == [1, 2, 3, 4]
    assert all(r["dtype"] == "bfloat16" for r in runs)
    assert "dtype=torch.bfloat16" in port.stdout
    verify = [json.loads(l.split(" ", 1)[1]) for l in port.stdout.splitlines()
              if l.startswith("verify ")]
    assert [(v["rtol"], v["atol"]) for v in verify] == [(1e-5, 1e-7)] * 2
    assert _verdicts(port.stdout) == [
        "1dev.w1 vs tp.w1", "1dev.w2 vs tp.w2", "ddp.w1 vs fsdp.w1",
        "ddp.w2 vs fsdp.w2"]
    # a step or two of the weights, not a wrong run
    for v in verify:
        assert 0 < max(v["max_abs_diff"].values()) <= 1e-3


@pytest.mark.parametrize("extra", [
    ("-m", "3", "--optimizer", "adamw"), ("-m", "2", "--optimizer",
                                           "momentum"),
    ("-m", "3", "--clip_norm", "0.5"),
    ("-m", "2", "--optimizer", "adam"), ("-m", "2", "--zero1"),
    ("-m", "3", "--clip_norm", "1.0"), ("-m", "1", "--mixed")])
def test_cli_refuses_bf16_where_it_is_not_ported(extra, capsys):
    """The optimizer options on bf16 params exit 2, naming the queue
    they wait in (methods 7, 8 and 11 train on bf16:
    ``test_torch_lm_bf16.py``, ``test_torch_train_lm_tp_bf16.py``,
    ``test_torch_train_moe_bf16.py``)."""
    from distributed_llm_code_samples_tpu_torch import cli
    assert cli.main(["--device", "cpu", "--dtype", "bfloat16",
                     *extra]) == 2
    assert "ROADMAP.md Queue 1" in capsys.readouterr().err


def test_cli_float32_dtype_changes_nothing(capsys):
    """``--dtype float32`` is the default: the same parameters, steps and
    checksums bit for bit."""
    from distributed_llm_code_samples_tpu_torch import cli
    args = ["--device", "cpu", "-m", "1", "-s", "2", "-bs", "2", "-n", "8",
            "-l", "2", "-d", "16", "-r", "7", "--lr", "0.1"]
    outs = []
    for extra in ([], ["--dtype", "float32"]):
        assert cli.main(args + extra) == 0
        run = json.loads(capsys.readouterr().out.splitlines()[-1])
        outs.append((run["dtype"], run["layer_checksums"]))
    assert outs[0] == outs[1] and outs[0][0] == "float32"
