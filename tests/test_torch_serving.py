"""The port's serving slice as a whole against the JAX package, on the CPU.

``repro_torch.launch.serve.serve`` (decode steps through the decode
kernel's plain version, K segments archived into the tiered store, lookback
reads through the page kernels' plain versions) is held against the same
loop built from the JAX package's pieces, as ``repro.launch.serve`` writes
it, with the same weights (converted by ``params_from_jax``).  Logits agree
at 1e-4 (float32 matmuls summed in another order) with both loops fed the
same tokens; the greedy tokens and the tiered store's counters are equal.
The port's ``BatchScheduler`` is held against JAX's on the requests of
``tests/test_serving.py``: equal outputs, tick for tick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.devices import make_device as jax_make_device
from repro.distributed.step import make_serve_step as jax_make_serve_step
from repro.models import transformer as JT
from repro.serving import scheduler as JS
from repro.tiered.store import TieredStore as JaxStore
from repro.tiered.store import TieredStoreConfig as JaxConfig
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import main, serve
from repro_torch.models.transformer import decode_step, init_decode_state
from repro_torch.serving import scheduler as S

SETTINGS = dict(batch=2, prompt_len=8, gen=40, context=32, policy="lru",
                kv_page_tokens=4, seed=3)


def _jax_serve(cfg, params, batch, prompt_len, gen, context, policy,
               kv_page_tokens, seed):
    """``repro.launch.serve.main``'s loop, returning what it computes."""
    serve_step = jax.jit(jax_make_serve_step(cfg, mesh=None))
    state = JT.init_decode_state(params, cfg, batch, context)
    hd = cfg.resolved_head_dim
    n_kv_pages = max(context // kv_page_tokens * 4, 8)
    tiered = JaxStore(
        JaxConfig(n_logical_pages=n_kv_pages,
                  page_shape=(cfg.n_layers, batch, kv_page_tokens,
                              cfg.n_kv_heads, hd),
                  hbm_pages=max(n_kv_pages // 4, 2), policy=policy),
        backing=jax_make_device("cxl-ssd"))
    rng = np.random.default_rng(seed)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (batch,)), jnp.int32)
    n_steps = prompt_len + gen
    ring = state["k"].shape[2]
    all_logits, all_tokens = [], []
    for step in range(n_steps):
        logits, state = serve_step(params, state, tokens)
        logits = logits[..., :cfg.vocab]
        tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        all_logits.append(np.asarray(logits))
        all_tokens.append(np.asarray(tokens))
        if ring and (step + 1) % kv_page_tokens == 0:
            seg = (step + 1) // kv_page_tokens - 1
            lo = (seg * kv_page_tokens) % ring
            if lo + kv_page_tokens <= ring:
                page = np.asarray(state["k"][:, :, lo:lo + kv_page_tokens])
                tiered.write_page(seg % n_kv_pages, page)
                if seg > 2:
                    picks = rng.integers(0, seg, size=2) % n_kv_pages
                    tiered.read_pages(list(picks))
    return np.stack(all_logits), np.stack(all_tokens), tiered


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_get_arch("h2o-danube-3-4b").reduced()
    cfg = get_arch("h2o-danube-3-4b").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(SETTINGS["seed"]), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    return jcfg, cfg, jparams, params


def test_serve_loop_matches_the_jax_loop(reduced):
    jcfg, cfg, jparams, params = reduced
    j_logits, j_tokens, j_store = _jax_serve(jcfg, jparams, **SETTINGS)
    forced = serve(params, cfg, forced=j_tokens, keep_logits=True,
                   **SETTINGS)
    np.testing.assert_allclose(torch.stack(forced.logits).numpy(), j_logits,
                               rtol=1e-4, atol=1e-4)
    greedy = serve(params, cfg, **SETTINGS)
    np.testing.assert_array_equal(greedy.tokens, j_tokens)
    assert greedy.steps == 48 and greedy.state["cur"] == 48  # ring of 32
    for res in (forced, greedy):
        assert res.tiered.stats == j_store.stats
        assert res.tiered.sim_ticks == j_store.sim_ticks
        for lpn in range(j_store.cfg.n_logical_pages):
            np.testing.assert_allclose(res.tiered.capacity_page(lpn),
                                       j_store.capacity_page(lpn),
                                       rtol=1e-4, atol=1e-4)
    assert j_store.stats["reads"] == 18 and j_store.stats["misses"] > 0


def test_serve_cli_prints_the_reference_lines(capsys):
    main(["--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu",
          "--batch", "2", "--prompt-len", "4", "--gen", "12",
          "--context", "16", "--kv-page-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] arch=h2o-danube-3-4b-smoke batch=2 "
                               "steps=16 (")
    assert lines[1].startswith("[serve] tiered-KV: hit-rate=")


# ---------------------------------------------------------------- scheduler
@pytest.fixture(scope="module")
def engines():
    jcfg = jax_get_arch("minicpm-2b").reduced()
    cfg = get_arch("minicpm-2b").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    jstep = jax.jit(lambda st, toks: JT.decode_step(jparams, jcfg, st, toks))

    def make(slots, port):
        if port:
            return S.BatchScheduler(
                lambda st, toks: decode_step(params, cfg, st, toks),
                lambda b: init_decode_state(params, cfg, b, context_len=64),
                S.SchedulerConfig(batch_slots=slots), cfg.vocab,
                torch_device="cpu")
        return JS.BatchScheduler(
            jstep, lambda b: JT.init_decode_state(jparams, jcfg, b,
                                                  context_len=64),
            JS.SchedulerConfig(batch_slots=slots), jcfg.vocab)

    return make


def _drive(sched, mod, scenario):
    R = mod.Request
    if scenario == "single":
        sched.submit(R(rid=1, prompt=np.asarray([5, 6, 7], np.int32),
                       max_new_tokens=4))
    elif scenario == "more_than_slots":
        for rid in range(5):
            sched.submit(R(rid=rid, prompt=np.asarray([rid + 1, rid + 2],
                                                      np.int32),
                           max_new_tokens=3))
    elif scenario == "mid_flight_join":
        sched.submit(R(rid=1, prompt=np.asarray([3], np.int32),
                       max_new_tokens=6))
        sched.run(max_ticks=3)
        sched.submit(R(rid=2, prompt=np.asarray([9, 9], np.int32),
                       max_new_tokens=2))
    elif scenario == "shared_batch":
        sched.submit(R(rid=1, prompt=np.asarray([11, 12], np.int32),
                       max_new_tokens=3))
        sched.submit(R(rid=2, prompt=np.asarray([40, 41, 42], np.int32),
                       max_new_tokens=3))
    done = sched.run()
    return {rid: (r.output, r.done) for rid, r in done.items()}, sched.ticks


@pytest.mark.parametrize("scenario", ["single", "more_than_slots",
                                      "mid_flight_join", "shared_batch"])
def test_scheduler_matches_jax(engines, scenario):
    slots = 2
    got = _drive(engines(slots, True), S, scenario)
    want = _drive(engines(slots, False), JS, scenario)
    assert got == want
    assert all(len(out) for out, _ in got[0].values())


def test_scheduler_eos_matches_jax(engines):
    """As in tests/test_serving.py: the first greedy token of one request
    becomes the EOS of an identical one, which then stops early."""
    runs = []
    for port, mod in ((True, S), (False, JS)):
        prompt = np.asarray([5, 6, 7], np.int32)
        first_run = engines(2, port)
        first_run.submit(mod.Request(rid=1, prompt=prompt, max_new_tokens=4))
        first = first_run.run()[1].output[0]
        again = engines(2, port)
        again.submit(mod.Request(rid=2, prompt=prompt, max_new_tokens=8,
                                 eos_id=first))
        runs.append((first, again.run()[2].output))
    assert runs[0] == runs[1]
    first, out = runs[0]
    assert out[-1] == first and len(out) < 8
