"""The port's moe, ssm, hybrid and audio families against the JAX package,
on the CPU.

The same seeded numpy inputs (or the JAX package's own weights, carried
across by ``params_from_jax``, and its decode state, by
``decode_state_from_jax``) go through the JAX functions and their ports.
Tolerances: the MoE and SSD layers 1e-5 (float32 rounding of the same
formulas; the SSD sums its chunk products in another order), the MoE
dispatch exact (which tokens each expert takes, and so which it drops);
model logits, aux losses, caches and SSM states 1e-4 (two layers of
float32 matmuls summed in another order, as in
``tests/test_torch_models.py``); the port's own prefill against its
decode 2e-3 (``tests/test_models_smoke.py::test_prefill_decode_parity``).
On the CPU the kernels' wrappers run their plain versions, which
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernels
against on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import decode_state_from_jax, params_from_jax
from repro_torch.distributed.step import make_prefill_step, make_serve_step
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

FAMILIES = ["mixtral-8x7b", "kimi-k2-1t-a32b", "mamba2-2_7b", "hymba-1_5b",
            "musicgen-large"]
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PARITY_TOL = dict(rtol=2e-3, atol=2e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, tol, where=""):
    """``got`` (the port's nested dicts) against ``want`` (JAX's dicts and
    named tuples), leaf by leaf."""
    want = want._asdict() if hasattr(want, "_asdict") else want
    assert set(got) == set(want), where
    for k, g in got.items():
        if isinstance(g, dict):
            _close_tree(g, want[k], tol, f"{where}{k}/")
        else:
            np.testing.assert_allclose(_np(g), np.asarray(want[k]), **tol,
                                       err_msg=f"{where}{k}")


def _models(arch, seed=0):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_jax(_tree_np(jparams), cfg, torch_device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, rng, *lead):
    shape = lead + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


# ------------------------------------------------------------------ layers
def test_embed_codebooks_matches():
    rng = np.random.default_rng(0)
    tables = rng.standard_normal((4, 50, 24)).astype(np.float32)
    grid = rng.integers(0, 50, (3, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(L.embed_codebooks(_t(tables), _t(grid).long())),
        np.asarray(JL.embed_codebooks(tables, grid)))


# --------------------------------------------------------------------- moe
def _moe_inputs(seed, T_, D, E, tied=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T_, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if tied:                         # experts 1 and 2 always tie, as 0 and 3
        router[:, 2] = router[:, 1]
        router[:, 3] = router[:, 0]
    return x, router


@pytest.mark.parametrize("tied", [False, True])
def test_route_matches_jax_top_k_order(tied):
    x, router = _moe_inputs(1, 64, 32, 6, tied)
    w, idx, aux = M._route(_t(x), _t(router), 3)
    jw, jidx, jaux = JM._route(x, router, 3)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_allclose(_np(w), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if tied:                         # a tie goes to the lower expert index
        assert (_np(idx)[:, :2] != [2, 1]).any(axis=1).all()


@pytest.mark.parametrize("capacity", [1, 5, 48, 400])
def test_dispatch_indices_match_jax(capacity):
    rng = np.random.default_rng(2)
    idx = np.stack([rng.permutation(8)[:3] for _ in range(100)]).astype(
        np.int32)
    slots, valid = M._dispatch_indices(_t(idx).long(), 8, capacity)
    jslots, jvalid = JM._dispatch_indices(jnp.asarray(idx), 8, capacity)
    np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(_np(slots)[_np(valid)],
                                  np.asarray(jslots)[np.asarray(jvalid)])


def _moe_params(seed, D, cfg):
    rng = np.random.default_rng(seed)
    shapes = M.moe_param_shapes(D, cfg)
    return {k: (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("arch,cf,tied", [
    ("mixtral-8x7b", None, False),   # the reduced config's 8.0: no drop
    ("mixtral-8x7b", 0.5, False),    # drops most assignments over 64 tokens
    ("kimi-k2-1t-a32b", 0.5, True),  # drops, with tied router columns
    ("kimi-k2-1t-a32b", 1.0, False),
])
def test_moe_ffn_local_matches_jax(arch, cf, tied):
    cfg = get_arch(arch).reduced().moe
    jcfg = jax_get_arch(arch).reduced().moe
    D, T_ = 32, 64
    p = _moe_params(3, D, cfg)
    x, p["router"] = _moe_inputs(4, T_, D, cfg.n_experts, tied)
    got, aux = M.moe_ffn_local(_t(x), {k: _t(v) for k, v in p.items()}, cfg,
                               capacity_factor=cf)
    want, jaux = JM.moe_ffn_local(x, JM.MoEParams(**p), jcfg,
                                  capacity_factor=cf)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # the same assignments dropped: the tokens whose expert is full
    _, idx, _ = M._route(_t(x), _t(p["router"]), cfg.top_k)
    C = M.capacity_for(T_, cfg, cf)
    assert C == JM.capacity_for(T_, jcfg, cf)
    slots, valid = M._dispatch_indices(idx, cfg.n_experts, C)
    _, jidx, _ = JM._route(x, p["router"], cfg.top_k)
    jslots, jvalid = JM._dispatch_indices(jidx, cfg.n_experts, C)
    kept = set(_np(slots)[_np(valid)].tolist())
    assert kept == set(np.asarray(jslots)[np.asarray(jvalid)].tolist())
    dropped = T_ * cfg.top_k - len(kept)
    assert (dropped > 0) == (cf is not None and cf < 8.0), dropped
    if dropped:                      # a dropped-only token's output is zero
        alone = [t for t in range(T_)
                 if not any(t * cfg.top_k + k in kept
                            for k in range(cfg.top_k))]
        assert not _np(got)[alone].any()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_ffn_sharded_on_one_rank_is_moe_ffn_local(arch, tmp_path):
    """The sharded MoE on a 1 x 1 gloo mesh of this process (its
    collectives move nothing) gives moe_ffn_local's output and aux; its
    body is the reference's choice (``tp`` whenever the model axis has
    one rank), with its ``in_specs`` as the blocks.  The 2 x 2 mesh runs
    in tests/test_torch_mesh_islands.py."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    cfg = get_arch(arch).reduced().moe
    for n_tp, resident, want in ((1, True, "tp"), (2, False, cfg.sharding),
                                 (2, True, "resident" if cfg.sharding == "ep"
                                  else "tp"), (3, False, "tp")):
        assert M.moe_mode(cfg, n_tp, resident) == want
    assert M.expert_specs("tp", ("data",), "model")["w_down"] == \
        (None, "model", None)
    assert M.expert_specs("resident", ("data",), "model")["w_gate"] == \
        ("model", None, "data")
    x = np.random.default_rng(4).standard_normal((3, 2, 64)).astype(
        np.float32)
    p = {k: _t(v) for k, v in JM.init_moe_params(
        jax.random.PRNGKey(4), 64, jax_get_arch(arch).reduced().moe
    )._asdict().items()}
    want, aux_want = M.moe_ffn_local(_t(x).reshape(-1, 64), p, cfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        for resident in (False, True):
            got, aux = M.moe_ffn_sharded(_t(x), p, cfg, mesh, ("data",),
                                         "model", resident_experts=resident)
            assert torch.equal(got.reshape(-1, 64), want)
            assert float(aux) == float(aux_want)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- ssm
def _ssm(seed, D=48):
    jcfg = jax_get_arch("mamba2-2_7b").reduced().ssm
    cfg = get_arch("mamba2-2_7b").reduced().ssm
    jp = JS.init_ssm_params(jax.random.PRNGKey(seed), D, jcfg)
    p = {k: _t(v) for k, v in jp._asdict().items()}
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("seq", [5, 8, 21])     # under, at, past chunks of 8
def test_ssd_forward_matches_jax(seq):
    jcfg, cfg, jp, p = _ssm(0)
    u = np.random.default_rng(seq).standard_normal((2, seq, 48)).astype(
        np.float32)
    np.testing.assert_allclose(_np(S.ssd_forward(_t(u), p, cfg)),
                               np.asarray(JS.ssd_forward(u, jp, jcfg)), **TOL)


def test_ssd_decode_steps_match_jax():
    jcfg, cfg, jp, p = _ssm(1)
    state = S.init_ssm_state(3, 48, cfg)
    jstate = JS.init_ssm_state(3, 48, jcfg)
    _close_tree(state, jstate, TOL)
    assert state["h"].dtype == torch.float32
    rng = np.random.default_rng(5)
    for step in range(6):            # past the conv buffer's 3 rows
        u = rng.standard_normal((3, 48)).astype(np.float32)
        y, state = S.ssd_decode_step(_t(u), state, p, cfg)
        jy, jstate = JS.ssd_decode_step(u, jstate, jp, jcfg)
        np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        _close_tree(state, jstate, TOL, f"step {step}/")


def test_init_ssm_params_has_the_reference_constants():
    jcfg, cfg, jp, _ = _ssm(2)
    gen = torch.Generator().manual_seed(0)
    p = S.init_ssm_params(
        48, cfg, lambda shape, std: torch.randn(shape, generator=gen) * std,
        device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp._asdict().items()}
    for k in ("A_log", "D_skip", "dt_bias", "norm_w", "conv_bx", "conv_bB",
              "conv_bC"):
        np.testing.assert_allclose(_np(p[k]), np.asarray(getattr(jp, k)),
                                   rtol=1e-7, err_msg=k)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    jcfg, cfg, jparams, params = _models(arch)
    tokens = _tokens(cfg, np.random.default_rng(11), 2, 9)
    want, jaux = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                            remat=False)
    got, aux = T.forward(params, cfg, {"tokens": _t(tokens)})
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)
    assert (float(jaux) > 0) == (cfg.moe is not None)
    logits = make_prefill_step(cfg, torch_device="cpu")(
        params, {"tokens": tokens})
    np.testing.assert_allclose(_np(logits), _np(got), rtol=0, atol=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_jax(arch):
    """10 steps from one converted state: logits, caches and SSM states."""
    jcfg, cfg, jparams, params = _models(arch, seed=3)
    B, context = 3, 16
    jstate = JT.init_decode_state(jparams, jcfg, B, context)
    state = decode_state_from_jax(_tree_np(jstate), cfg, torch_device="cpu")
    jstep = jax.jit(lambda s, t: JT.decode_step(jparams, jcfg, s, t))
    step = make_serve_step(cfg)
    toks = _tokens(cfg, np.random.default_rng(12), 10, B)
    for i in range(10):
        jl, jstate = jstep(jstate, jnp.asarray(toks[i]))
        lg, state = step(params, state, _t(toks[i]))
        assert lg.shape == jl.shape
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL,
                                   err_msg=f"step {i}")
    assert state["cur"] == int(jstate["cur"]) == 10
    _close_tree({k: v for k, v in state.items() if k != "cur"},
                {k: v for k, v in jstate.items() if k != "cur"}, MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_parity(arch):
    """The port's token-by-token decode reproduces its own forward."""
    cfg = get_arch(arch).reduced()
    params = T.init_params(cfg, 1, torch_device="cpu")
    tokens = _t(_tokens(cfg, np.random.default_rng(9), 2, 10))
    full, _ = T.forward(params, cfg, {"tokens": tokens})
    state = T.init_decode_state(params, cfg, 2, 10)
    step = make_serve_step(cfg)
    outs = []
    for t in range(10):
        lg, state = step(params, state, tokens[:, t])
        outs.append(lg)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               **PARITY_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_reference_layout(arch):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    want = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.init_params(cfg, 0, torch_device="cpu")

    def shapes(tree):
        tree = tree._asdict() if hasattr(tree, "_asdict") else tree
        return {k: shapes(v) if isinstance(v, dict) or hasattr(v, "_asdict")
                else tuple(v.shape) for k, v in tree.items()}

    assert shapes(params) == shapes(want) == T.param_shapes(cfg)
    again = T.init_params(cfg, 0, torch_device="cpu")
    assert torch.equal(again["embed"], params["embed"])        # seeded


# -------------------------------------------------------------- converters
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_refuses_a_wrong_tree(arch):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    good = _tree_np(JT.init_params(jax.random.PRNGKey(0), jcfg))
    params_from_jax(good, cfg, torch_device="cpu")
    name = "moe" if cfg.moe is not None else "ssm" if cfg.ssm else None
    if name:
        leaf = good["blocks"][name]
        bad = dict(good, blocks=dict(good["blocks"],
                                     **{name: leaf._replace(**{
                                         leaf._fields[0]: np.zeros((1, 2))})}))
        with pytest.raises(ValueError, match=f"{name}/{leaf._fields[0]}"):
            params_from_jax(bad, cfg, torch_device="cpu")
        fewer = dict(leaf._asdict())
        fewer.pop(leaf._fields[-1])
        bad = dict(good, blocks=dict(good["blocks"], **{name: fewer}))
        with pytest.raises(ValueError, match="keys"):
            params_from_jax(bad, cfg, torch_device="cpu")
    bad = dict(good, blocks=dict(good["blocks"], extra=np.zeros(2)))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, cfg, torch_device="cpu")
    head = np.zeros(np.shape(good["embed"])[:-1] + (3,))
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(dict(good, embed=head), cfg, torch_device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_state_from_jax_refuses_a_wrong_state(arch):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    good = _tree_np(JT.init_decode_state(jparams, jcfg, 2, 12))
    state = decode_state_from_jax(good, cfg, torch_device="cpu")
    assert state["cur"] == 0 and isinstance(state["cur"], int)
    layout = T.decode_state_layout(cfg, 2, 12)
    assert set(state) - {"cur"} == set(layout)
    if "ssm" in good:
        ssm = good["ssm"]
        bad = dict(good, ssm=ssm._replace(h=ssm.h[..., :1]))
        with pytest.raises(ValueError, match="ssm/h"):
            decode_state_from_jax(bad, cfg, torch_device="cpu")
        bad = dict(good, ssm=ssm._replace(h=ssm.h.astype(np.float16)))
        with pytest.raises(ValueError, match="dtype"):
            decode_state_from_jax(bad, cfg, torch_device="cpu")
    if "k" in good:
        bad = {k: v for k, v in good.items() if k != "v"}
        with pytest.raises(ValueError, match="keys"):
            decode_state_from_jax(bad, cfg, torch_device="cpu")
    with pytest.raises(ValueError, match="keys"):
        decode_state_from_jax(dict(good, extra=np.zeros(1)), cfg,
                              torch_device="cpu")


# ------------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_runs_the_family_as_the_reference_loop(arch):
    """The reference's loop: no store without attention (ring 0), (batch,
    n_codebooks) token grids for audio; teacher-forced logits equal to
    JAX decode steps on the same weights and tokens."""
    jcfg, cfg, jparams, params = _models(arch, seed=4)
    kw = dict(batch=2, prompt_len=4, gen=12, context=16, kv_page_tokens=4,
              seed=4)
    forced = _tokens(cfg, np.random.default_rng(13), 16, 2)
    res = serve(params, cfg, forced=forced, keep_logits=True, **kw)
    assert res.tokens.shape == forced.shape
    assert (res.tiered is None) == (cfg.n_heads == 0)
    if res.tiered is not None:
        assert res.tiered.stats["writebacks"] + res.tiered.stats["fills"] >= 0
        assert len(res.report()) == 2
    else:
        assert len(res.report()) == 1
    jstate = JT.init_decode_state(jparams, jcfg, 2, 16)
    tok = np.random.default_rng(4).integers(
        0, cfg.vocab, forced.shape[1:]).astype(np.int32)
    for i in range(16):
        jl, jstate = JT.decode_step(jparams, jcfg, jstate, jnp.asarray(tok))
        np.testing.assert_allclose(_np(res.logits[i]),
                                   np.asarray(jl)[..., :cfg.vocab],
                                   **MODEL_TOL, err_msg=f"step {i}")
        tok = forced[i]
