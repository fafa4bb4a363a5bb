"""The port's serving slice held against the JAX package: scheduler and
paging replays compared state for state, and the port's paged, greedy
``ContinuousEngine`` giving the same tokens as the JAX ``ContinuousEngine``
and JAX ``generate`` on seeded traces, dense and ``auto_fact``-ed, with and
without a shared prefix (fp32 on the CPU).  Also the engine's refusals and
the device policy of the entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.core import auto_fact as jax_auto_fact
from repro.models import build_model
from repro.nn.module import named_parameters as jax_named_parameters
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import PagedCacheManager as JaxManager
from repro.serve import Request as JaxRequest
from repro.serve import Scheduler as JaxScheduler
from repro.serve import generate
from repro.serve import make_trace as jax_make_trace
from repro.serve import replay as jax_replay

import repro_torch.configs as tcfg
from repro_torch import bridge
from repro_torch.models import TransformerLM
from repro_torch.serve import ContinuousEngine, PagedCacheManager, Request
from repro_torch.serve import Scheduler, UnsupportedCacheError
from repro_torch.serve import make_trace, replay

MAX_LEN, MAX_PROMPT, BATCH, BS, CHUNK = 48, 24, 3, 4, 8


# ---- host-side bookkeeping: state for state ------------------------------------


def _sched_state(s):
    return (s.n_pending, [r.uid for r in s.pending],
            [None if x is None else (x.request.uid, list(x.tokens))
             for x in s.slots], sorted(s.prefilling), s.idle,
            s.running_slots(), s.free_slot())


def test_scheduler_replay_matches_jax_state_for_state():
    rng = np.random.default_rng(0)
    j, t = JaxScheduler(3, aging_every=2), Scheduler(3, aging_every=2)
    uid_map = {}
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            prio, plen = int(rng.integers(0, 3)), int(rng.integers(1, 6))
            prompt = rng.integers(0, 50, plen)
            ju = j.submit(JaxRequest(prompt=prompt, max_new_tokens=3,
                                     priority=prio))
            tu = t.submit(Request(prompt=prompt, max_new_tokens=3,
                                  priority=prio))
            uid_map[ju] = tu
        elif op == 1:
            ja, ta = j.next_admission(), t.next_admission()
            assert (ja is None) == (ta is None)
            if ja is not None:
                assert ja[0] == ta[0] and uid_map[ja[1].uid] == ta[1].uid
                j.begin_prefill(*ja)
                t.begin_prefill(*ta)
                j.bind(ja[0], ja[1], 7)
                t.bind(ta[0], ta[1], 7)
        elif op == 2 and j.running_slots():
            slot = j.running_slots()[0]
            j.append_token(slot, 9)
            t.append_token(slot, 9)
            jc, tc = j.finish(slot, "length"), t.finish(slot, "length")
            assert uid_map[jc.uid] == tc.uid and jc.tokens == tc.tokens
        jst, tst = _sched_state(j), _sched_state(t)
        assert jst[0] == tst[0] and [uid_map[u] for u in jst[1]] == tst[1]
        assert [None if x is None else (uid_map[x[0]], x[1])
                for x in jst[2]] == tst[2]
        assert jst[3:] == tst[3:]


def test_paging_replay_matches_jax_state_for_state():
    """admit / scatter_rows / publish / release through both managers on
    prompts sharing prefixes: same tables, hits, refcounts and LRU."""
    rng = np.random.default_rng(1)
    kw = dict(n_blocks=12, block_size=4, batch=3, max_len=24,
              retain_blocks=4)
    j, t = JaxManager(**kw), PagedCacheManager(**kw)
    prefix = rng.integers(0, 30, 8)
    live = set()
    for _ in range(40):
        free = [s for s in range(3) if s not in live]
        if free and rng.random() < 0.6:
            tail = rng.integers(0, 30, int(rng.integers(1, 9)))
            prompt = np.concatenate([prefix, tail]).astype(np.int32)
            total = min(prompt.size + int(rng.integers(1, 6)), 24)
            ok = j.can_admit(prompt, total)
            assert ok == t.can_admit(prompt, total)
            if ok:
                s = free[0]
                assert j.admit(s, prompt, total) == t.admit(s, prompt, total)
                np.testing.assert_array_equal(
                    j.scatter_rows(s, 0, 8, lo=0, hi=prompt.size),
                    t.scatter_rows(s, 0, 8, lo=0, hi=prompt.size))
                j.publish(s, prompt.size)
                t.publish(s, prompt.size)
                live.add(s)
        elif live:
            s = sorted(live)[int(rng.integers(0, len(live)))]
            assert j.release(s) == t.release(s)
            live.discard(s)
        np.testing.assert_array_equal(j.tables, t.tables)
        np.testing.assert_array_equal(j.allocator.refcount,
                                      t.allocator.refcount)
        assert list(j.retained) == list(t.retained)
        assert j.prefix_hit_tokens == t.prefix_hit_tokens
        assert j.allocator.n_free == t.allocator.n_free


# ---- the slice as a whole -------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """(jax cfg, port cfg, {"dense": jax model, "fact": jax model}); the
    factorized model is auto_fact-ed in JAX and carried across whole."""
    jc = jcfg.get_config("qwen2.5-3b").reduced()
    dense = build_model(jax.random.PRNGKey(0), jc)
    fact = jax_auto_fact(dense, 0.5, solver="svd",
                         exclude=["embed", "lm_head"], gate=False)
    return jc, tcfg.get_config("qwen2.5-3b").reduced(), {"dense": dense,
                                                         "fact": fact}


def _port(jmodel, tc):
    params = {k: np.asarray(v) for k, v in jax_named_parameters(jmodel)}
    return bridge.from_jax(params, tc, device="cpu")


def _generate(jmodel, jc, prompt, n):
    cache = jmodel.init_cache(1, MAX_LEN, jc, dtype=jnp.float32)
    out, _ = generate(jmodel, jnp.asarray(prompt)[None, :], cache, n_steps=n)
    return np.asarray(out)[0].tolist()


@pytest.mark.parametrize("kind", ["dense", "fact"])
@pytest.mark.parametrize("shared_prefix", [0, 9])
def test_engine_tokens_match_jax_engine_and_generate(models, kind,
                                                     shared_prefix):
    jc, tc, jmodels = models
    jmodel = jmodels[kind]
    kw = dict(seed=11 + shared_prefix, load=0.8, min_prompt=2,
              max_prompt=MAX_PROMPT - shared_prefix, min_new=2, max_new=6,
              vocab=jc.vocab, shared_prefix=shared_prefix)
    jtrace, ttrace = jax_make_trace(6, **kw), make_trace(6, **kw)
    for (ja, jr), (ta, tr) in zip(jtrace, ttrace):
        assert ja == ta and jr.max_new_tokens == tr.max_new_tokens
        np.testing.assert_array_equal(jr.prompt, tr.prompt)
    dims = dict(batch=BATCH, max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                block_size=BS, chunk_size=CHUNK)
    jeng = JaxEngine(jmodel, jc, **dims)
    jdone, _ = jax_replay(jeng, jtrace)
    teng = ContinuousEngine(_port(jmodel, tc), tc, **dims)
    tdone, _ = replay(teng, ttrace)
    assert len(tdone) == len(jdone) == 6
    for (_, req), jd, td in zip(ttrace, jdone, tdone):
        assert td.tokens == jd.tokens, (
            f"port diverged from the JAX engine on a {req.prompt.size}-token "
            f"prompt: {td.tokens} vs {jd.tokens}")
        assert td.finish_reason == jd.finish_reason == "length"
        assert len(td.tokens) == req.max_new_tokens
        assert td.prompt_len == req.prompt.size
    # one-shot generate, the JAX package's reference of the engine itself
    for (_, req), td in zip(ttrace, tdone):
        assert td.tokens == _generate(jmodel, jc, req.prompt,
                                      req.max_new_tokens)
    ts, js = teng.prefill_stats(), jeng.prefill_stats()
    for key in ("prompt_tokens_admitted", "prefill_tokens_computed",
                "prefill_tokens_padded", "prefix_skipped_tokens",
                "prefill_chunks", "max_step_prefill_tokens"):
        assert ts[key] == js[key], key
    tk, jk = teng.kv_stats(), jeng.kv_stats()
    for key in ("kv_allocated_bytes", "peak_blocks_in_use",
                "prefix_hit_tokens", "blocks_in_use", "blocks_retained"):
        assert tk[key] == jk[key], key
    if shared_prefix:
        assert tk["prefix_hit_tokens"] > 0
    assert teng.manager.allocator.n_in_use == 0


def test_engine_stop_ids_and_cache_full_match_jax(models):
    jc, tc, jmodels = models
    jmodel = jmodels["dense"]
    prompts = [np.arange(5, dtype=np.int32) + 3, np.arange(20, dtype=np.int32)]
    dims = dict(batch=2, max_len=28, max_prompt_len=22, block_size=BS,
                chunk_size=CHUNK)
    jeng, teng = JaxEngine(jmodel, jc, **dims), ContinuousEngine(
        _port(jmodel, tc), tc, **dims)
    first = _generate(jmodel, jc, prompts[0], 3)
    for eng in (jeng, teng):
        eng.submit(prompts[0], max_new_tokens=10, stop_ids=(first[2],))
        eng.submit(prompts[1], max_new_tokens=20)
    jd, td = jeng.run(), teng.run()
    assert [c.tokens for c in td] == [c.tokens for c in jd]
    assert [c.finish_reason for c in td] == [c.finish_reason for c in jd]
    assert [c.finish_reason for c in td] == ["stop", "cache_full"]


# ---- refusals and the device policy ---------------------------------------------


@pytest.fixture(scope="module")
def cpu_model():
    tc = tcfg.get_config("paper-tiny").reduced()
    return tc, TransformerLM.create(tc, device="cpu")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(kv_layout="dense"), UnsupportedCacheError, "dense KV layout"),
    (dict(decode_kernel="pallas"), ValueError, "'reference', 'cuda'"),
    (dict(prefill_kernel="pallas"), ValueError, "'reference', 'cuda'"),
    (dict(draft_model=object(), spec_k=2), NotImplementedError,
     "speculative"),
    (dict(mesh=object()), NotImplementedError, "dist and XLA"),
    (dict(preemption=True), NotImplementedError, "preemption"),
])
def test_engine_refuses_what_is_not_ported(cpu_model, kw, exc, match):
    tc, model = cpu_model
    with pytest.raises(exc, match=match):
        ContinuousEngine(model, tc, batch=2, max_len=32, max_prompt_len=8,
                         **kw)


def test_engine_refuses_sampled_decoding_and_other_kinds(cpu_model):
    tc, model = cpu_model
    eng = ContinuousEngine(model, tc, batch=2, max_len=32, max_prompt_len=8)
    with pytest.raises(NotImplementedError, match="injected noise"):
        eng.submit(np.arange(3), max_new_tokens=2, temperature=0.7)
    with pytest.raises(UnsupportedCacheError, match="other families"):
        ContinuousEngine(model, tc.replace(window=8), batch=2, max_len=32,
                         max_prompt_len=8)
    with pytest.raises(UnsupportedCacheError, match="other families"):
        TransformerLM.create(tcfg.get_config("mamba2-2.7b").reduced(),
                             device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.launch import serve as port_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tcfg.get_config("paper-tiny").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM.create(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.from_jax({}, tc)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_serve.main(["--reduced", "--n-requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert port_serve.main(["--reduced", "--device", "cpu", "--n-requests",
                            "2", "--max-new", "4", "--factorize",
                            "--shared-prefix", "8"]) == 0
