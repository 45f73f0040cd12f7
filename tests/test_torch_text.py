"""Real text and sampling of the port against the JAX package's, on the
CPU.

- The port's corpus copy is byte-equal to JAX's; its training windows lie
  in bounds and never touch the held-out tail.
- ``models.lm.sample`` handed JAX's Gumbel draws (``noise_fn``; JAX's
  ``categorical`` is ``argmax(z + gumbel(fold_in(base, pos)))``) gives
  JAX's tokens, and raises JAX's errors.
- ``train_real_text.train_text`` at d 32, 2 layers, 4 heads, T 32, B 4,
  8 steps in 2 segments, from JAX's ``init_lm`` and fed JAX's windows,
  gives the loss curve of JAX's ``train_real_text.py`` run at the same
  settings within rtol 2e-4 plus 1e-4 (the AdamW LM tolerance,
  ``test_torch_checkpoint_resume.py``, and the rounding of both curves to
  4 decimals) and the same best step; the restored best params equal the
  params saved at that step. The port's entry point prints JAX's lines
  and payload keys.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import (
    load_text_corpus as j_corpus)
from distributed_llm_code_samples_tpu.data import (
    text_batch_from_seed as j_text_batch)
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.models.lm import sample as j_sample
from distributed_llm_code_samples_tpu_torch import train_real_text as trt
from distributed_llm_code_samples_tpu_torch.data import (
    TokenTable, load_text_corpus, text_batch_from_seed)
from distributed_llm_code_samples_tpu_torch.models import (
    lm_leaves, lm_params_from_numpy, sample)
from torch_serve_refs import one_thread  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_corpus_copy_is_byte_equal():
    ours, theirs = load_text_corpus(), np.asarray(j_corpus())
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape == (237320,)
    assert ours.tobytes() == theirs.tobytes()


def test_windows_stay_in_bounds_and_off_the_tail():
    corpus = load_text_corpus()
    train, held = trt.split_corpus(corpus, 0.10, 64)
    assert train.shape[0] + held.shape[0] == corpus.shape[0]
    starts = []
    for seed in range(40):
        toks, tgts = text_batch_from_seed(seed, 8, 64, corpus=train)
        assert toks.shape == tgts.shape == (8, 64) and toks.dtype == torch.long
        assert torch.equal(toks[:, 1:], tgts[:, :-1])
        # the starts a generator seeded with the seed draws, JAX's bound
        gen = torch.Generator().manual_seed(seed)
        s = torch.randint(0, train.shape[0] - 64, (8,), generator=gen)
        for i, st in enumerate(s.tolist()):
            window = train[st:st + 65]
            assert toks[i].tolist() == window[:-1].tolist()
            assert tgts[i].tolist() == window[1:].tolist()
        starts += s.tolist()
    assert min(starts) >= 0 and max(starts) + 64 < train.shape[0]
    # the same seed, the same windows; the bound is JAX's (len - T)
    a, _ = text_batch_from_seed(7, 4, 64, corpus=train)
    b, _ = text_batch_from_seed(7, 4, 64, corpus=train)
    assert torch.equal(a, b)
    small = np.arange(10, dtype=np.uint8)
    toks, tgts = text_batch_from_seed(3, 64, 8, corpus=small)
    assert int(tgts.max()) <= 9 and set(toks[:, 0].tolist()) <= {0, 1}


@pytest.fixture(scope="module")
def lm():
    return j_init_lm(jax.random.PRNGKey(0), 64, 32, 2, max_seq_len=24,
                     n_heads=4)


@pytest.mark.parametrize("temperature,top_k,seed", [(0.8, 5, 7),
                                                    (1.3, 0, 2),
                                                    (0.5, 64, 9)])
def test_sample_with_jax_noise_gives_jax_tokens(lm, temperature, top_k,
                                                seed):
    prompt = np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    want = j_sample(lm, jnp.asarray(prompt), 12, 4, temperature=temperature,
                    top_k=top_k, seed=seed)
    base = jax.random.fold_in(jax.random.PRNGKey(0x5A3), seed)

    def noise(pos, shape):
        return np.asarray(jax.random.gumbel(jax.random.fold_in(base, pos),
                                            shape))
    got = sample(lm_params_from_numpy(lm), prompt, 12, 4,
                 temperature=temperature, top_k=top_k, seed=seed,
                 noise_fn=noise)
    assert got.tolist() == np.asarray(want).tolist()
    # the default noise: reproducible, and the prompt is kept
    a = sample(lm_params_from_numpy(lm), prompt, 12, 4, seed=seed)
    b = sample(lm_params_from_numpy(lm), prompt, 12, 4, seed=seed)
    assert torch.equal(a, b) and a[:, :5].tolist() == prompt.tolist()


@pytest.mark.parametrize("kw", [{"temperature": 0.0}, {"top_k": 65},
                                {"top_k": -1}])
def test_sample_errors_match_jax(lm, kw):
    prompt = np.array([[1, 2]], np.int32)
    with pytest.raises(ValueError) as jerr:
        j_sample(lm, jnp.asarray(prompt), 2, 4, **kw)
    with pytest.raises(ValueError) as perr:
        sample(lm_params_from_numpy(lm), prompt, 2, 4, **kw)
    assert str(perr.value) == str(jerr.value)


SHAPE = dict(TEXTLM_D="32", TEXTLM_LAYERS="2", TEXTLM_HEADS="4",
             TEXTLM_SEQ="32", TEXTLM_BATCH="4", TEXTLM_STEPS="8",
             TEXTLM_SEGMENTS="2")


def test_real_text_loop_matches_jax_script(tmp_path, monkeypatch, capsys):
    for k, v in SHAPE.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TEXTLM_ARTIFACT", str(tmp_path / "jax.json"))
    monkeypatch.delenv("TEXTLM_CKPT_DIR", raising=False)
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    spec = importlib.util.spec_from_file_location(
        "jax_train_real_text", os.path.join(ROOT, "train_real_text.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main() == 0
    capsys.readouterr()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    cfg = trt.config()
    corpus = np.asarray(j_corpus())
    train, held = trt.split_corpus(corpus, cfg["holdout"], cfg["seq"])
    b, t = cfg["batch"], cfg["seq"]

    def windows(seed, part):
        return tuple(np.array(a) for a in j_text_batch(
            jnp.int32(seed), b, t, corpus=jnp.asarray(part)))
    table = TokenTable({s: windows(s, train) for s in range(cfg["steps"])})
    evals = [tuple(torch.from_numpy(a).long() for a in windows(s, part))
             for s, part in zip(trt.EVAL_SEEDS, (train, held))]
    params = lm_params_from_numpy(j_init_lm(jax.random.PRNGKey(0), 256,
                                            cfg["d"], cfg["layers"],
                                            max_seq_len=t))
    saved = {}
    run = trt.train_text(
        params, table, evals, steps=cfg["steps"], segments=cfg["segments"],
        batch=b, seq=t, heads=cfg["heads"], lr=cfg["lr"],
        ckpt_dir=str(tmp_path / "ck"),
        on_point=lambda point, p: saved.__setitem__(
            point["step"], [x.clone() for x in lm_leaves(p)]))
    curve = run["curve"]
    assert [p["step"] for p in curve] == [p["step"] for p in
                                          want["loss_curve"]] == [0, 4, 8]
    for got, ref in zip(curve, want["loss_curve"]):
        for key in ("train_loss", "holdout_loss"):
            assert abs(got[key] - ref[key]) <= 2e-4 * abs(ref[key]) + 1e-4, (
                got, ref)
    assert run["best_step"] == want["best_step"]
    assert curve[-1]["holdout_loss"] < curve[0]["holdout_loss"]
    for a, w in zip(lm_leaves(run["best_params"]), saved[run["best_step"]]):
        assert torch.equal(a, w)
    # the port's entry point on the CPU: JAX's lines and payload keys, its
    # own artifact name by default
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("TEXTLM_ARTIFACT", str(tmp_path / "port.json"))
    assert trt.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [set(json.loads(ln)) for ln in lines[:3]] == [
        {"step", "train_loss", "holdout_loss"}] * 3
    with open(tmp_path / "port.json") as f:
        payload = json.load(f)
    assert set(payload) == set(want) and payload["device_kind"] == "cpu"
    assert payload["uniform_loss"] == want["uniform_loss"] == 5.5452
    assert len(payload["sample"]) >= len(trt.PROMPT)
    monkeypatch.delenv("TEXTLM_ARTIFACT")
    assert trt.config()["artifact"] == "TEXTLM_torch.json"
