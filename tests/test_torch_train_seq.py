"""The port's sequence-parallel trainers (``train_lm_seq``,
``train_transformer_seq``) and ``cli.py -m 13`` against the JAX package
on the CPU.

vocab 96, d 32, 2 layers, 4 heads, 64-token sequences, 2 a step (128
tokens), 2 seeds, lr 0.1 (at the package's 1e-5 a lost gradient sum
would hide below the tolerance: JAX's ``test_lm.py`` reason); the bf16
runs at 40-token sequences (10 rows a rank, no multiple of 32). Both
sides start from the JAX ``init_lm`` / ``init_transformer`` parameters
and the port trains on the JAX batches (a ``TokenTable`` /
``BatchTable``). The port's ranks are threads of a loopback mesh on the
CPU (plain collectives), the CLI's 4 gloo processes; JAX's train on the
conftest's fake devices, its Pallas kernels in interpret mode.

The port is held against JAX's ``train_lm_seq`` where that is green
(flash attention, the fused head) and against JAX's single-device
trainers everywhere, as JAX's own tests hold its seq trainers: JAX's seq
trainers with the oracle attention and head fail on this JAX version
(ROADMAP Queue 3). Tolerance: ``tests/test_lm.py``'s rtol 2e-4, atol
2e-5. Data x seq ``{data: 2, seq: 4}`` equals the port's DDP over
``{data: 2}`` within the same. bf16: each leaf's ``|port - ref| <= 0.3
|ref - start|`` (``test_torch_train_lm_tp_bf16.py``'s share of the
update) against JAX's bf16 ``train_lm_seq`` under ``STRICT`` and the
port's own bf16 ``train_lm_single``: the ranks round their partial
products and the ring its merges to bf16, where one device rounds the
whole contraction once. Measured at most 0.082 against JAX's ring and
0.235 against the port's single device (on ``wq``, the leaf that moves
least); JAX's bf16 ring itself misses 0.227 of the port's single device.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.models import (
    init_transformer as j_init_transformer)
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_seq as j_train_lm_seq)
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_single as j_train_lm_single)
from distributed_llm_code_samples_tpu.parallel import (
    train_transformer_single as j_train_tr_single)
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import BatchTable, TokenTable
from distributed_llm_code_samples_tpu_torch.models import (
    init_lm, lm_leaves, lm_params_from_numpy, transformer_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.optim import adamw
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, train_lm_ddp, train_lm_seq,
    train_lm_single, train_transformer_ddp, train_transformer_seq)

from torch_bf16_ranks import update_gap

V, D, L, H, SEQ, LR, N = 96, 32, 2, 4, 64, 0.1, 4
TOKENS = 2 * SEQ
TOL = dict(rtol=2e-4, atol=2e-5)
BF, SEQ_BF, BF16_GAP = jnp.bfloat16, 40, 0.3
STRICT = {"xla_allow_excess_precision": False}
# (seq_impl, attn_impl, head_impl) of the runs held against JAX's green
# train_lm_seq
POLICIES = [("ring", "flash", None), ("ulysses", "flash", None),
            ("ring", None, "fused"), ("ring", "flash", "fused")]
IDS = [f"{s}-{a or 'oracle'}-{h or 'oracle'}" for s, a, h in POLICIES]


def _loopback(axes):
    return Mesh(dict(axes), "cpu", loopback=True)


def _seeds(n=2):
    return np.asarray(make_seed_schedule(n, random_seed=17))


@pytest.fixture(scope="module")
def setup():
    lm = j_init_lm(jax.random.PRNGKey(3), V, D, L, SEQ, n_heads=H)
    trunk = j_init_transformer(jax.random.PRNGKey(4), D, L)
    seeds = _seeds(4)
    tokens = TokenTable({int(s): tuple(np.asarray(a) for a in j_lm_batch(
        jnp.int32(s), TOKENS // SEQ, SEQ, V)) for s in seeds})
    batches = BatchTable({int(s): tuple(np.asarray(a) for a in
                                        j_batch(jnp.int32(s), TOKENS, D))
                          for s in seeds})
    return dict(lm=lm, trunk=trunk, tokens=tokens, batches=batches,
                lm_start=lm_params_from_numpy(lm),
                trunk_start=transformer_params_from_numpy(trunk))


def _close(got, want):
    want = (jax.tree_util.tree_leaves(want) if not isinstance(
        want, torch.nn.Module) else [t for _, t in want.named_leaves()])
    got = [t for _, t in got.named_leaves()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


def _moved(got, start):
    # the run moved the weights by 40x the tolerance (a lost sum over the
    # ranks would miss most of that)
    assert float((got.blocks.w1 - start.blocks.w1).abs().max()) > 1e-3


@functools.lru_cache(maxsize=None)
def _j_lm(kind, seq_impl=None, attn=None, head=None):
    params = j_init_lm(jax.random.PRNGKey(3), V, D, L, SEQ, n_heads=H)
    seeds = jnp.asarray(_seeds())
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H)
    if kind == "single":
        return j_train_lm_single(params, seeds, TOKENS, D, **kw)
    return j_train_lm_seq(params, seeds, TOKENS, D, j_mesh({SEQ_AXIS: N}),
                          seq_impl=seq_impl, attn_impl=attn, head_impl=head,
                          **kw)


def _lm_seq(setup, axes=None, seeds=None, **kw):
    return train_lm_seq(setup["lm_start"], _seeds() if seeds is None
                        else seeds, TOKENS, D,
                        _loopback(axes or {SEQ_AXIS: N}), lr=LR,
                        seq_len=SEQ, n_heads=H, batch_fn=setup["tokens"],
                        timeout=120, **kw)


@pytest.mark.parametrize("seq_impl,attn,head", POLICIES, ids=IDS)
def test_lm_seq_matches_jax(setup, seq_impl, attn, head):
    """``train_lm_seq`` with flash attention (the kernels on each ring hop,
    or on Ulysses' local heads) and with the fused head on each rank's
    token block == JAX's ``train_lm_seq`` and JAX's single-device
    trainer."""
    got = _lm_seq(setup, seq_impl=seq_impl, attn_impl=attn, head_impl=head)
    _close(got, _j_lm("seq", seq_impl, attn, head))
    _close(got, _j_lm("single"))
    _moved(got, setup["lm_start"])


@pytest.mark.parametrize("seq_impl", ["ring", "ulysses"])
def test_lm_seq_oracle_matches_single(setup, seq_impl):
    """The oracle attention and head over the seq axis == JAX's
    ``train_lm_single`` (JAX's own seq trainer is red here)."""
    got = _lm_seq(setup, seq_impl=seq_impl)
    _close(got, _j_lm("single"))
    _moved(got, setup["lm_start"])


@functools.lru_cache(maxsize=None)
def _j_trunk(causal):
    params = j_init_transformer(jax.random.PRNGKey(4), D, L)
    return j_train_tr_single(params, jnp.asarray(_seeds()), TOKENS, D,
                             lr=LR, seq_len=SEQ, n_heads=H, causal=causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq_impl", ["ring", "ulysses"])
def test_transformer_seq_matches_single(setup, seq_impl, causal):
    """``train_transformer_seq`` (the oracle ring or Ulysses, causal or
    not) == JAX's ``train_transformer_single``."""
    got = train_transformer_seq(setup["trunk_start"], _seeds(), TOKENS, D,
                                _loopback({SEQ_AXIS: N}), lr=LR, seq_len=SEQ,
                                n_heads=H, causal=causal, seq_impl=seq_impl,
                                batch_fn=setup["batches"], timeout=120)
    _close(got, _j_trunk(causal))
    assert float((got.w1 - setup["trunk_start"].w1).abs().max()) > 1e-3


def test_data_x_seq_equals_ddp(setup):
    """On ``{data: 2, seq: 4}`` each data row trains its strided seeds with
    its sequence over the seq axis, and one sum spans both axes: the LM
    (flash ring, fused head) and the transformer (Ulysses) equal the
    port's DDP over ``{data: 2}``."""
    axes, seeds = {DATA_AXIS: 2, SEQ_AXIS: N}, _seeds(4)
    got = _lm_seq(setup, axes, seeds, attn_impl="flash", head_impl="fused")
    want = train_lm_ddp(setup["lm_start"], seeds, TOKENS, D,
                        _loopback({DATA_AXIS: 2}), lr=LR, seq_len=SEQ,
                        n_heads=H, attn_impl="flash", head_impl="fused",
                        batch_fn=setup["tokens"], timeout=120)
    _close(got, want)
    _moved(got, setup["lm_start"])
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup["batches"],
              timeout=120)
    _close(train_transformer_seq(setup["trunk_start"], seeds, TOKENS, D,
                                 _loopback(axes), seq_impl="ulysses", **kw),
           train_transformer_ddp(setup["trunk_start"], seeds, TOKENS, D,
                                 _loopback({DATA_AXIS: 2}), **kw))


@functools.lru_cache(maxsize=None)
def _bf16_setup():
    lm = j_init_lm(jax.random.PRNGKey(5), V, D, L, SEQ_BF, n_heads=H,
                   dtype=BF)
    seeds = _seeds()
    tokens = TokenTable({int(s): tuple(np.array(a) for a in j_lm_batch(
        jnp.int32(s), 2, SEQ_BF, V)) for s in seeds})
    want = jax.tree_util.tree_leaves(jax.jit(
        lambda p, s: j_train_lm_seq(p, s, 2 * SEQ_BF, D,
                                    j_mesh({SEQ_AXIS: N}), lr=LR,
                                    seq_len=SEQ_BF, n_heads=H,
                                    attn_impl="flash"),
        compiler_options=STRICT)(lm, jnp.asarray(seeds)))
    return lm_params_from_numpy(lm), seeds, tokens, want


@pytest.mark.parametrize("seq_impl", ["ring", "ulysses"])
def test_bf16_lm_seq(seq_impl):
    """``--dtype bfloat16`` (flash attention, the oracle head): the bf16
    run misses at most ``BF16_GAP`` of each leaf's update against the
    port's own bf16 ``train_lm_single`` and (the ring) JAX's bf16
    ``train_lm_seq`` under ``STRICT``; every leaf stays bf16."""
    start, seeds, tokens, want = _bf16_setup()
    kw = dict(lr=LR, seq_len=SEQ_BF, n_heads=H, attn_impl="flash",
              batch_fn=tokens)
    got = train_lm_seq(start, seeds, 2 * SEQ_BF, D, _loopback({SEQ_AXIS: N}),
                       seq_impl=seq_impl, timeout=120, **kw)
    single = train_lm_single(start, seeds, 2 * SEQ_BF, D, **kw)
    refs = [lm_leaves(single)] + ([want] if seq_impl == "ring" else [])
    for ref in refs:
        gaps = [update_gap(g, w, s) for g, w, s in
                zip(lm_leaves(got), ref, lm_leaves(start))]
        assert max(gaps) <= BF16_GAP, gaps
    assert all(t.dtype == torch.bfloat16 for t in lm_leaves(got))


CLI = ["--device", "cpu", "--fake_devices", "4", "-m", "13", "-s", "2",
       "-bs", "2", "-n", "64", "-l", "2", "-d", "32", "-r", "7", "--lr",
       "0.1", "--vocab", "96"]


@pytest.mark.parametrize("flags", [
    ["--seq_impl", "ring"], ["--seq_impl", "ulysses"],
    ["--attn", "flash", "--head", "fused"]],
    ids=["ring", "ulysses", "flash-fused"])
def test_cli_method_13_trains_as_single(capsys, flags):
    """``-m 13`` on 4 gloo ranks: the payload, and the final layers'
    checksums against the port's ``train_lm_single`` from the CLI's own
    init (rtol 1e-5)."""
    assert cli.main(CLI + flags) == 0
    out = capsys.readouterr().out
    payload = json.loads(out.strip().splitlines()[-1])
    args = cli.build_parser().parse_args(CLI + flags)
    assert payload["mesh"] == {SEQ_AXIS: 4} and payload["ranks"] == 4
    assert payload["seq_impl"] == args.seq_impl
    assert (payload["attn"], payload["head"]) == (args.attn, args.head)
    assert payload["kernel_launches_per_rank"] == [{}] * 4
    gen = torch.Generator()
    gen.manual_seed(7)
    params = cli._init(args, gen)
    assert f"PARAMS: {params.num_params():_}" in out
    want = train_lm_single(params, make_seed_schedule(2, 7), 128, 32,
                           lr=0.1, seq_len=64, n_heads=4,
                           attn_impl=args.attn, head_impl=args.head)
    np.testing.assert_allclose(payload["layer_checksums"],
                               cli._checksums(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flags,axes", [
    (["-n", "6"], {SEQ_AXIS: 2}),
    (["--seq_impl", "ulysses", "--heads", "2", "-d", "8"], {SEQ_AXIS: 2}),
    (["--seq_impl", "ulysses", "--heads", "3", "-d", "6"], {SEQ_AXIS: 1})],
    ids=["seq6", "ulysses-heads2", "ulysses-heads3"])
def test_cli_method_13_mesh(flags, axes):
    """The seq axis takes the most ranks that divide ``-n`` and, under
    Ulysses, ``--heads`` (JAX ``cli.py``)."""
    args = cli.build_parser().parse_args(CLI + flags)
    meshes = cli._meshes(args, args.batch_size * args.seq_len, [0, 1],
                         torch.device("cpu"))
    assert meshes[13].shape == axes


@pytest.mark.parametrize("flags,message", [
    (["-m", "13", "--attn", "rope"],
     "--attn rope is not supported by --method 13"),
    (["-m", "13", "--kv_heads", "2"],
     "--method 13 (sequence-parallel LM) supports full MHA only"),
    (["-m", "5", "--attn", "flash"], "--attn applies to --method 8, 11, 13"),
    (["-m", "2", "--head", "fused"],
     "--head fused applies to --method 11 (LM TP), 12 (MoE LM EP), 13"),
    (["-m", "13", "--tp", "2"], "--tp applies to --method 5, 8 or 11"),
    (["-m", "13", "-d", "30"], "model_size=30 not divisible by n_heads=4")],
    ids=["m13-rope", "m13-kv", "attn-m5", "head-m2", "tp-m13", "heads-d"])
def test_cli_refuses_with_jax_messages(capsys, flags, message):
    assert cli.main(CLI + flags) == 2
    out = capsys.readouterr()
    assert out.out == "" and message in out.err


def test_trainer_refusals(setup):
    """Before any rank starts: JAX's trainer has no optimizer, ``mixed`` or
    guard; the seq axis is required; full MHA only; the sequence must
    split over the ranks."""
    for kw in (dict(optimizer=adamw()), dict(mixed=True),
               dict(guard=object())):
        with pytest.raises(NotImplementedError, match="not ported"):
            _lm_seq(setup, **kw)
    with pytest.raises(ValueError, match="needs \\['seq'\\]"):
        _lm_seq(setup, {MODEL_AXIS: 4})
    with pytest.raises(ValueError, match="seq_len=64 not divisible"):
        _lm_seq(setup, {SEQ_AXIS: 3})
    gqa = init_lm(torch.Generator().manual_seed(0), V, D, L, SEQ, n_heads=H,
                  n_kv_heads=2)
    with pytest.raises(ValueError, match="full MHA"):
        train_lm_seq(gqa, _seeds(), TOKENS, D, _loopback({SEQ_AXIS: 2}),
                     seq_len=SEQ, n_heads=H)


def test_cli_method_13_without_a_card_exits_2(capsys):
    """Without ``--device cpu`` the CLI runs on the card, and without one
    it exits 2 before anything starts, as the other methods do."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the method would run on it")
    assert cli.main(["-m", "13", "-s", "1", "-n", "64", "-d", "32"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is False" in out.err
