"""The port's optimizer, schedules, gradient compression, training loader,
straggler watchdog, optimizer checkpoints and training driver, against the
JAX package where it has a counterpart, on the CPU (mirroring
``tests/test_optim_data_ckpt.py``).

Tolerances: the schedules and one AdamW step 1e-6 relative (float32
formulas; XLA's and PyTorch's ``pow`` may differ in the last bit); 60
AdamW steps on a quadratic 1e-5; the int8 codecs and the compression
transfer function exact on the same inputs (the same float32 quotient,
rounded half to even); the loader's batches bit-identical (numpy on both
sides); a resumed training run equal to the uninterrupted one
(deterministic CPU float32, the same batches).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import ShardedLoader as JaxLoader
from repro.data.pipeline import make_batch_spec as jax_batch_spec
from repro.distributed.straggler import StragglerConfig as JaxStragglerConfig
from repro.distributed.straggler import StragglerWatchdog as JaxWatchdog
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedules as JSCH
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import ShardedLoader, make_batch_spec
from repro_torch.distributed.straggler import (StragglerConfig,
                                               StragglerWatchdog)
from repro_torch.launch import train
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.optim import schedules as SCH
from repro_torch.tree import tree_leaves, tree_map


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pair(seed, shapes):
    rng = np.random.default_rng(seed)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


# ------------------------------------------------------------- schedules
def test_schedules_equal_the_reference():
    pairs = [(JSCH.wsd_schedule(1.0, 10, 50, 20, 0.1),
              SCH.wsd_schedule(1.0, 10, 50, 20, 0.1)),
             (JSCH.wsd_schedule(3e-3, 5, 140, 50),
              SCH.wsd_schedule(3e-3, 5, 140, 50)),
             (JSCH.cosine_schedule(1.0, 10, 100),
              SCH.cosine_schedule(1.0, 10, 100))]
    for jl, tl in pairs:
        for step in range(0, 220, 3):
            got = tl(step)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jl(step)),
                                       rtol=1e-6, atol=0)
    lr = SCH.wsd_schedule(1.0, 10, 50, 20, 0.1)
    assert float(lr(0)) == 0.0 and float(lr(200)) == pytest.approx(0.1)


# ----------------------------------------------------------------- adamw
SHAPES = {"a": (4, 4), "b": (3,), "c": (2, 3, 5)}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0), (0.05, 0.1)])
def test_adamw_step_equals_the_reference(clip, wd):
    jp, tp = _pair(0, SHAPES)
    jg, tg = _pair(1, SHAPES)
    jcfg = JA.AdamWConfig(grad_clip=clip, weight_decay=wd)
    cfg = A.AdamWConfig(grad_clip=clip, weight_decay=wd)
    jstate, state = JA.adamw_init(jp), A.adamw_init(tp)
    for _ in range(3):
        jp, jstate = JA.adamw_update(jg, jstate, jp, jnp.asarray(0.01), jcfg)
        tp, state = A.adamw_update(tg, state, tp, torch.tensor(0.01), cfg)
    for k in SHAPES:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(state["mu"][k]),
                                   np.asarray(jstate["mu"][k]), rtol=1e-6)
        np.testing.assert_allclose(_np(state["nu"][k]),
                                   np.asarray(jstate["nu"][k]), rtol=1e-6)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 3


def test_adamw_converges_as_the_reference():
    jp, tp = _pair(2, SHAPES)
    cfg, jcfg = A.AdamWConfig(weight_decay=0.0), JA.AdamWConfig(
        weight_decay=0.0)
    jstate, state = JA.adamw_init(jp), A.adamw_init(tp)

    def jloss(p):
        return sum(jnp.sum(jnp.square(v)) for v in jax.tree.leaves(p))

    l0 = sum(float((v ** 2).sum()) for v in tp.values())
    for _ in range(60):
        jp, jstate = JA.adamw_update(jax.grad(jloss)(jp), jstate, jp,
                                     jnp.asarray(0.05), jcfg)
        tp, state = A.adamw_update({k: 2 * v for k, v in tp.items()}, state,
                                   tp, 0.05, cfg)
    assert sum(float((v ** 2).sum()) for v in tp.values()) < l0 * 0.1
    for k in SHAPES:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-5)


def test_adamw_clips_keeps_bf16_and_updates_in_place():
    p = {"w": torch.ones(4)}
    w = p["w"]
    p1, _ = A.adamw_update({"w": torch.full((4,), 1e6)}, A.adamw_init(p), p,
                           0.1, A.AdamWConfig(grad_clip=1.0,
                                              weight_decay=0.0))
    assert p1["w"] is w and float((1 - w).abs().max()) < 0.2
    pb = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = A.adamw_init(pb)
    assert state["mu"]["w"].dtype == torch.float32
    pb, state = A.adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)},
                               state, pb, 0.01)
    assert pb["w"].dtype == torch.bfloat16 and int(state["count"]) == 1
    with pytest.raises(ValueError, match="moment_dtype"):
        A.adamw_init(p, "fp8")


def test_int8_codecs_equal_the_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 33)) * np.logspace(-6, 1, 33)
         ).astype(np.float32)
    x[3] = 0.0
    for jenc, enc, data in ((JA._q8_encode_signed, A._q8_encode_signed, x),
                            (JA._q8_encode_unsigned, A._q8_encode_unsigned,
                             np.abs(x))):
        jq, js = jenc(jnp.asarray(data))
        q, s = enc(torch.from_numpy(data))
        assert q.dtype == torch.int8 and s.dtype == torch.float16
        np.testing.assert_array_equal(_np(q), np.asarray(jq))
        np.testing.assert_array_equal(_np(s), np.asarray(js))
    jq, js = JA._q8_encode_signed(jnp.asarray(x))
    np.testing.assert_array_equal(
        _np(A._q8_decode_signed(torch.from_numpy(np.asarray(jq)),
                                torch.from_numpy(np.asarray(js)))),
        np.asarray(JA._q8_decode_signed(jq, js)))


def test_int8_moments_converge_and_are_smaller():
    params = {"a": torch.ones(8, 16), "b": torch.ones(5)}
    cfg = A.AdamWConfig(weight_decay=0.0, moment_dtype="int8")
    state = A.adamw_init(params, "int8")
    assert state["mu_q"]["a"].dtype == torch.int8
    assert state["mu_s"]["a"].shape == (8,) and \
        state["mu_s"]["b"].shape == ()
    l0 = sum(float((v ** 2).sum()) for v in params.values())
    for _ in range(80):
        params, state = A.adamw_update({k: 2 * v for k, v in params.items()},
                                       state, params, 0.05, cfg)
    assert sum(float((v ** 2).sum()) for v in params.values()) < l0 * 0.05
    big = {"w": torch.ones(64, 256)}

    def nbytes(tree):
        return sum(v.nbytes for v in tree_leaves(tree))

    assert nbytes(A.adamw_init(big, "int8")) < 0.3 * nbytes(
        A.adamw_init(big))


# ------------------------------------------------------------ compression
def test_compression_equals_the_reference():
    jg, tg = _pair(5, SHAPES)
    jst, st = JC.compress_init(jg), C.compress_init(tg)
    for i in range(20):
        scale = 1.0 + i
        jcg, jst = JC.compressed_gradients(
            {k: v * scale for k, v in jg.items()}, jst)
        cg, st = C.compressed_gradients(
            {k: v * scale for k, v in tg.items()}, st)
        for k in SHAPES:
            np.testing.assert_array_equal(_np(cg[k]), np.asarray(jcg[k]))
            np.testing.assert_array_equal(_np(st.residual[k]),
                                          np.asarray(jst.residual[k]))
    g = {"w": torch.linspace(-1, 1, 256)}
    cg, _ = C.compressed_gradients(g, C.compress_init(g))
    assert float((cg["w"] - g["w"]).abs().max()) <= 1.0 / 127 + 1e-6


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["minicpm-2b", "musicgen-large",
                                  "llama-3_2-vision-90b"])
def test_loader_batches_are_the_references(arch):
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    assert make_batch_spec(cfg, 32, 4) == jax_batch_spec(jcfg, 32, 4)
    for shard in (0, 1):
        a = ShardedLoader(cfg, 32, 4, shard=shard, num_shards=2, seed=7)
        b = JaxLoader(jcfg, 32, 4, shard=shard, num_shards=2, seed=7)
        for _ in range(3):
            got, want = a.next(), b.next()
            assert set(got) == set(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        assert a.state() == b.state()


def test_loader_restores_its_cursor():
    cfg = get_arch("minicpm-2b").reduced()
    a = ShardedLoader(cfg, 32, 4, seed=7)
    for _ in range(5):
        a.next()
    st = a.state()
    more = [a.next() for _ in range(3)]
    b = ShardedLoader(cfg, 32, 4, seed=7)
    b.restore(st)
    for want in more:
        np.testing.assert_array_equal(b.next()["tokens"], want["tokens"])
    with pytest.raises(ValueError, match="seed"):
        ShardedLoader(cfg, 32, 4, seed=8).restore(st)


# -------------------------------------------------------------- straggler
def test_watchdog_reports_equal_the_references():
    durations = [1.0, 1.1, 0.9, 1.0, 1.0, 1.05, 3.0, 1.0, 5.0, 5.0, 5.0, 1.0,
                 0.98, 4.0]
    hosts = [None, None, 1, 2, None, 3, 4, None, 4, 4, 4, 2, None, 1]
    mine = StragglerWatchdog(StragglerConfig(warmup_steps=3, threshold=2.0,
                                             evict_after=3))
    ref = JaxWatchdog(JaxStragglerConfig(warmup_steps=3, threshold=2.0,
                                         evict_after=3))
    for d, h in zip(durations, hosts):
        got, want = mine.end_step(host=h, duration_s=d), ref.end_step(
            host=h, duration_s=d)
        assert vars(got) == vars(want)
    assert mine.worst_hosts() == ref.worst_hosts() == [4, 1]
    mine.start_step()
    assert mine.end_step().duration_s >= 0


# ------------------------------------------------------- checkpoint, train
def test_checkpoint_keeps_an_int8_optimizer_state(tmp_path):
    params = {"w": torch.randn(4, 6), "n": {"b": torch.randn(5)}}
    opt = A.adamw_init(params, "int8")
    params, opt = A.adamw_update({"w": torch.randn(4, 6),
                                  "n": {"b": torch.randn(5)}}, opt, params,
                                 0.01, A.AdamWConfig(moment_dtype="int8"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"params": params, "opt": opt},
                   extra={"loader": {"step": 1, "shard": 0, "seed": 3}})
    mgr.wait()
    template = {"params": tree_map(torch.zeros_like, params),
                "opt": A.adamw_init(params, "int8")}
    back, extra, step = mgr.restore(template)
    assert step == 1 and extra["loader"]["step"] == 1
    for key in ("mu_q", "mu_s", "nu_q", "nu_s"):
        for got, want in zip(tree_leaves(back["opt"][key]),
                             tree_leaves(opt[key])):
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
    assert back["opt"]["count"].dtype == torch.int32
    assert int(back["opt"]["count"]) == 1


TRAIN = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
         "--batch", "4", "--seq", "32", "--log-every", "100"]


def test_train_main_lowers_the_loss():
    res = train.main(TRAIN + ["--steps", "40"])
    assert len(res.losses) == 40 and res.start_step == 0
    assert np.mean(res.losses[-10:]) < np.mean(res.losses[:10]) - 0.3


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_train_main_resumes_to_the_same_losses(tmp_path, moments):
    """A run checkpointed every 2 steps, cut after step 4 (its later
    checkpoint removed) and resumed, ends as the uninterrupted run."""
    args = TRAIN + ["--steps", "6", "--ckpt-every", "2",
                    "--moment-dtype", moments]
    full = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    cut = tmp_path / "b"
    train.main(args + ["--ckpt-dir", str(cut)])
    mgr = CheckpointManager(str(cut))
    assert sorted(mgr.all_steps()) == [2, 4, 6]
    import shutil
    shutil.rmtree(cut / "step_00000006")
    resumed = train.main(args + ["--ckpt-dir", str(cut), "--resume"])
    assert resumed.start_step == 4
    assert resumed.losses == full.losses[4:]
    for a, b in zip(tree_leaves(resumed.params),
                    tree_leaves(full.params)):
        assert torch.equal(a, b)
