"""The port's loss, optimizer, int8 error feedback and data pipeline
against the JAX package's, in process on the CPU (JAX on one device).

Tolerances: ``softmax_xent``, AdamW (clipping, decay on matrices only,
a callable learning rate) and ``warmup_cosine`` 1e-6 (the same float32
operations); ``compress_int8`` bitwise, payload and scale, rounding half
to even; the error-feedback residual bitwise after every step of a
50-step run, and the transmitted mean within 20 % of the true gradient
(``tests/test_data_optim.py:120``'s assertion); ``TokenPipeline``
bitwise, steps 0-3, row slices, the corpus file and the feature stubs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import blocks as jbl
from repro.optim import adamw as jaw
from repro.optim import dist as jdist
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro_torch.data import pipeline as tpipe
from repro_torch.models import blocks as tbl
from repro_torch.optim import adamw as taw
from repro_torch.optim import dist as tdist
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import tree_paths

RNG = np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


# -- the loss ----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_matches_jax(masked, z_loss):
    logits = (RNG.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = RNG.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (RNG.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jbl.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask),
                            z_loss)
    got = tbl.softmax_xent(_t(logits), _t(labels).long(),
                           None if mask is None else _t(mask), z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_softmax_xent_reads_bfloat16_logits_in_float32():
    logits = (RNG.standard_normal((2, 5, 40)) * 3).astype(np.float32)
    labels = RNG.integers(0, 40, (2, 5))
    bf = _t(logits).to(torch.bfloat16)
    got = tbl.softmax_xent(bf, _t(labels))
    assert got.dtype == torch.float32
    want = jbl.softmax_xent(jnp.asarray(bf.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


# -- AdamW and the schedule ----------------------------------------------------

def _tree(scale):
    """A parameter-shaped tree: matrices (decayed), vectors (not), a list
    of layer-stacked dicts, as the model's."""
    def a(*shape):
        return (RNG.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": a(12, 4), "final_norm": {"scale": a(4)},
            "segments": [{"b0_dense": {"mlp": {"wd": a(2, 6, 4)},
                                       "ln1": {"scale": a(2, 4)}}}]}


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_t(v) for v in tree]
    return _t(tree)


def _close_trees(port, jtree, tol):
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = {p: _np(v) for p, v in tree_paths(port)}
    assert got.keys() == jflat.keys()
    for p in got:
        np.testing.assert_allclose(got[p], jflat[p], rtol=tol, atol=tol,
                                   err_msg=p)


@pytest.mark.parametrize("lr", ["constant", "schedule"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])      # clip off / on
def test_adamw_matches_jax(lr, grad_scale):
    cfg_kw = dict(weight_decay=0.1, grad_clip=1.0)
    jlr = 3e-3 if lr == "constant" else jwarmup_cosine(3e-3, 2, 10)
    tlr = 3e-3 if lr == "constant" else warmup_cosine(3e-3, 2, 10)
    jcfg = jaw.AdamWConfig(lr=jlr, **cfg_kw)
    tcfg = taw.AdamWConfig(lr=tlr, **cfg_kw)
    params = _tree(1.0)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    jst, tst = jaw.adamw_init(jp), taw.adamw_init(tp)
    for _ in range(3):
        grads = _tree(grad_scale)
        jp, jst, jm = jaw.adamw_update(jcfg, jax.tree.map(jnp.asarray, grads),
                                       jst, jp)
        tp, tst, tm = taw.adamw_update(tcfg, _to_t(grads), tst, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    _close_trees(tp, jp, 1e-6)
    _close_trees(tst["m"], jst["m"], 1e-6)
    _close_trees(tst["v"], jst["v"], 1e-6)
    assert int(tst["count"]) == int(jst["count"]) == 3
    assert tst["count"].dtype == torch.int32


def test_adamw_keeps_float32_moments_and_the_parameter_dtype():
    p = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
         "b": torch.ones(2, dtype=torch.bfloat16)}
    st = taw.adamw_init(p)
    assert st["m"]["w"].dtype == st["v"]["b"].dtype == torch.float32
    cfg = taw.AdamWConfig(lr=0.5, weight_decay=1.0, grad_clip=1e9)
    zero = {"w": torch.zeros(3, 2, dtype=torch.bfloat16),
            "b": torch.zeros(2, dtype=torch.bfloat16)}
    new, st, _ = taw.adamw_update(cfg, zero, st, p)
    assert new["w"].dtype == torch.bfloat16
    # zero gradient: only the decay moves, and only the matrix
    assert torch.equal(new["w"], torch.full((3, 2), 0.5,
                                            dtype=torch.bfloat16))
    assert torch.equal(new["b"], p["b"])


def test_warmup_cosine_matches_jax():
    j, t = jwarmup_cosine(1e-3, 10, 100, 0.1), warmup_cosine(1e-3, 10, 100,
                                                              0.1)
    steps = np.arange(0, 121)
    np.testing.assert_allclose(_np(t(torch.from_numpy(steps))),
                               np.asarray(j(jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-12)
    assert float(t(0)) == 0.0
    assert float(t(100)) == pytest.approx(1e-4, rel=1e-2)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(taw.global_norm(t)) == pytest.approx(5.0)


# -- int8 compression and error feedback ------------------------------------------

def test_compress_int8_bitwise_with_jax_and_rounds_half_to_even():
    # max |x| 127: scale 1.0, so x / scale lands on the halves exactly
    x = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                   np.float32)
    for arr in (x, (RNG.standard_normal(4096) * 3).astype(np.float32),
                (RNG.standard_normal((8, 33)) * 1e-7).astype(np.float32),
                np.zeros(5, np.float32)):
        jq, js = jdist.compress_int8(jnp.asarray(arr))
        tq, ts = tdist.compress_int8(_t(arr))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(_np(tq), np.asarray(jq))
        assert _np(ts).tobytes() == np.asarray(js).tobytes()
        back = tdist.decompress_int8(tq, ts)
        assert _np(back).tobytes() == np.asarray(
            jdist.decompress_int8(jq, js)).tobytes()
    tq, _ = tdist.compress_int8(_t(x))
    assert _np(tq).tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_error_feedback_matches_jax_and_accumulates_residual():
    g = (RNG.standard_normal(64) * 1e-4).astype(np.float32)  # tiny grads
    jres = jdist.make_error_feedback({"g": jnp.asarray(g)})
    tres = tdist.make_error_feedback({"g": _t(g)})
    assert tres["g"].dtype == torch.float32 and not tres["g"].any()
    sent_total = torch.zeros(64)
    for _ in range(50):
        jq, jres = jdist.ef_compress_tree({"g": jnp.asarray(g)}, jres)
        tq, tres = tdist.ef_compress_tree({"g": _t(g)}, tres)
        np.testing.assert_array_equal(_np(tq["g"][0]),
                                      np.asarray(jq["g"][0]))
        assert _np(tres["g"]).tobytes() == np.asarray(jres["g"]).tobytes()
        sent = tdist.ef_decompress_tree(tq)["g"]
        sent_total = sent_total + sent
    # over 50 steps the mean transmitted approaches the true gradient
    np.testing.assert_allclose(_np(sent_total / 50), g,
                               atol=float(np.abs(g).max()) * 0.2)


# -- the data pipeline ------------------------------------------------------------

CFG = dict(vocab=500, batch=6, seq=24, seed=3)


@pytest.mark.parametrize("extra", [{}, {"kind": "embeddings", "d_model": 8},
                                   {"image_tokens": 3, "d_model": 8},
                                   {"zipf_a": 1.5}])
def test_token_pipeline_bitwise_with_jax(extra):
    jp = jpipe.TokenPipeline(jpipe.DataConfig(**CFG, **extra))
    tp = tpipe.TokenPipeline(tpipe.DataConfig(**CFG, **extra), device="cpu")
    state = tp.init_state()
    assert state == jp.init_state() == 0
    for step in range(4):
        want = jp.batch_at(step)
        got = tp.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        dev, state = tp.next_batch(state)
        assert state == step + 1
        for k in want:
            t = dev[k]
            assert t.dtype == (torch.int64 if want[k].dtype == np.int32
                               else torch.float32), k
            np.testing.assert_array_equal(_np(t), want[k])
    np.testing.assert_array_equal(tp.rows(2, 1, 4), jp.rows(2, 1, 4))
    np.testing.assert_array_equal(tp.rows(2, 1, 4), tp.rows(2)[1:4])


def test_token_pipeline_corpus_file_bitwise(tmp_path):
    jpath = jpipe.write_synthetic_corpus(str(tmp_path / "j.bin"), 5000, 300,
                                         seed=4)
    tpath = tpipe.write_synthetic_corpus(str(tmp_path / "t.bin"), 5000, 300,
                                         seed=4)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    cfg = dict(CFG, vocab=300, corpus=tpath)
    jp = jpipe.TokenPipeline(jpipe.DataConfig(**cfg))
    tp = tpipe.TokenPipeline(tpipe.DataConfig(**cfg), device="cpu")
    for step in range(4):
        for k, v in jp.batch_at(step).items():
            np.testing.assert_array_equal(tp.batch_at(step)[k], v)


def test_token_pipeline_defaults_to_the_card():
    cfg = tpipe.DataConfig(**CFG)
    if torch.cuda.is_available():
        assert tpipe.TokenPipeline(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.TokenPipeline(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jpipe.DataConfig(**CFG))
