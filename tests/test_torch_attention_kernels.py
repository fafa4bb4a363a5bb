"""The port's two attention kernels held against the JAX package on the CPU.

* Plain versions — ``paged_attention_torch`` and ``chunk_attention_torch``
  (what the wrappers run for a CPU tensor, and what ``chip_smoke.py`` holds
  the CUDA kernels against on the card) against the JAX Pallas kernels in
  interpret mode and the JAX oracles, at 1e-5 in fp32, on the cases of the
  JAX kernel tests: head ratios, ``bs = 1``, a bf16 pool, sentinel holes,
  fully masked slots and chunks, prefix resumes mid-block, random layouts.
* Layer — the port's ``Attention.decode``/``prefill_chunk`` with ``"cuda"``
  against its own reference path and the JAX layer with ``"pallas"``,
  over several chunks and decode steps, with bit-identical K/V writes.
* Engine — the port's ``ContinuousEngine(decode_kernel="cuda",
  prefill_kernel="cuda")`` gives the same greedy tokens as the JAX engine
  with ``"pallas"`` kernels and as JAX ``generate``, dense and factorized,
  and through the cache-full frozen slot.
* Wrappers — what they refuse, that a CPU call launches nothing, and the
  sources they build from.

Inputs are made with numpy from a seed and handed to both packages.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.core import auto_fact as jax_auto_fact
from repro.kernels import chunk_attention as jax_chunk_attention
from repro.kernels import chunk_attention_ref
from repro.kernels import paged_attention as jax_paged_attention
from repro.kernels import paged_attention_ref
from repro.kernels.ref import NEG_INF as JAX_NEG_INF
from repro.models import build_model
from repro.nn.attention import Attention as JaxAttention
from repro.nn.attention import PagedKVCache as JaxPagedKVCache
from repro.nn.module import named_parameters as jax_named_parameters
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import generate
from repro.serve import make_trace as jax_make_trace
from repro.serve import replay as jax_replay

import repro_torch.configs as tcfg
from repro_torch import bridge
from repro_torch.kernels import _paged
from repro_torch.kernels.chunk_attention import (chunk_attention,
                                                 chunk_attention_torch)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_torch)
from repro_torch.nn.attention import NEG_INF, Attention, PagedKVCache
from repro_torch.nn.linear import Linear
from repro_torch.serve import ContinuousEngine, make_trace, replay

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _t(a, dtype=None):
    """A numpy array as a torch tensor (bf16 through fp32)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    a = jnp.asarray(a)
    return a if dtype is None else a.astype(dtype)


# ---- case construction ------------------------------------------------------


def _paged_case(seed, *, batch, heads, kvh, hd, bs, n_table, extra_blocks=2):
    """Numpy inputs of one paged decode: each slot owns the distinct blocks
    its position needs, sentinel after; positions ragged across slots."""
    rng = np.random.default_rng(seed)
    n_blocks = batch * n_table + extra_blocks
    q = rng.standard_normal((batch, heads, hd)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    pos = rng.integers(0, n_table * bs, batch).astype(np.int32)
    table = np.full((batch, n_table), n_blocks, np.int32)
    perm = rng.permutation(n_blocks)
    used = 0
    for b in range(batch):
        need = pos[b] // bs + 1
        table[b, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, table, pos


def _paged_both(q, kp, vp, table, pos, *, q_dtype=np.float32,
                pool_dtype=np.float32):
    """(port plain version, JAX kernel, JAX oracle) on the same inputs, as
    fp32 numpy; bf16 inputs are rounded once in numpy-compatible form."""
    tq = {np.float32: torch.float32, "bf16": torch.bfloat16}[q_dtype]
    tp = {np.float32: torch.float32, "bf16": torch.bfloat16}[pool_dtype]
    jq = {np.float32: jnp.float32, "bf16": jnp.bfloat16}[q_dtype]
    jp = {np.float32: jnp.float32, "bf16": jnp.bfloat16}[pool_dtype]
    y = paged_attention(_t(q, tq), _t(kp, tp), _t(vp, tp), _t(table),
                        _t(pos))
    assert y.dtype == tq and y.shape == q.shape
    args = (_j(q, jq), _j(kp, jp), _j(vp, jp), _j(table), _j(pos))
    return _np(y), _np(jax_paged_attention(*args)), _np(
        paged_attention_ref(*args))


def _assert_paged(case, tol=TOL, **dtypes):
    y, yk, yr = _paged_both(*case, **dtypes)
    np.testing.assert_allclose(y, yk, err_msg="port vs JAX kernel", **tol)
    np.testing.assert_allclose(y, yr, err_msg="port vs JAX oracle", **tol)
    assert np.isfinite(y).all()
    return y


def _chunk_case(seed, *, heads, kvh, hd, bs, n_table, w, offset, n_valid,
                extra_blocks=2):
    """Numpy inputs of one slot's prefill chunk: a resident prefix of
    ``offset`` tokens behind a random table (sentinel tail), and a
    ``w``-wide chunk whose first ``n_valid`` rows are real."""
    rng = np.random.default_rng(seed)
    n_blocks = n_table + extra_blocks
    q = rng.standard_normal((w, heads, hd)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    kc = rng.standard_normal((w, kvh, hd)).astype(np.float32)
    vc = rng.standard_normal((w, kvh, hd)).astype(np.float32)
    need = -(-(offset + n_valid) // bs) if offset + n_valid else 0
    table = np.full((n_table,), n_blocks, np.int32)
    table[:need] = rng.permutation(n_blocks)[:need]
    return q, kp, vp, table, kc, vc, offset, n_valid


def _assert_chunk(case, tol=TOL, pool_dtype=np.float32):
    q, kp, vp, table, kc, vc, offset, n_valid = case
    tp = {np.float32: torch.float32, "bf16": torch.bfloat16}[pool_dtype]
    jp = {np.float32: jnp.float32, "bf16": jnp.bfloat16}[pool_dtype]
    y = chunk_attention(_t(q), _t(kp, tp), _t(vp, tp), _t(table),
                        _t(kc, tp), _t(vc, tp), offset, n_valid)
    assert y.dtype == torch.float32 and y.shape == q.shape
    args = (_j(q), _j(kp, jp), _j(vp, jp), _j(table), _j(kc, jp),
            _j(vc, jp), jnp.int32(offset), jnp.int32(n_valid))
    y = _np(y)
    # the contract covers the valid rows; padding rows must stay finite
    np.testing.assert_allclose(y[:n_valid],
                               _np(jax_chunk_attention(*args))[:n_valid],
                               err_msg="port vs JAX kernel", **tol)
    np.testing.assert_allclose(y[:n_valid],
                               _np(chunk_attention_ref(*args))[:n_valid],
                               err_msg="port vs JAX oracle", **tol)
    assert np.isfinite(y).all()
    return y


# ---- paged decode: plain version vs the JAX kernel and oracle ---------------


@pytest.mark.parametrize("heads,kvh", [(4, 4), (4, 2), (4, 1), (1, 1)])
def test_paged_head_ratios(heads, kvh):
    _assert_paged(_paged_case(7, batch=3, heads=heads, kvh=kvh, hd=16, bs=4,
                              n_table=5))


def test_paged_block_size_one_and_single_slot():
    _assert_paged(_paged_case(11, batch=1, heads=2, kvh=2, hd=8, bs=1,
                              n_table=6))


@pytest.mark.parametrize("q_dtype,tol",
                         [(np.float32, TOL), ("bf16", BF16_TOL)],
                         ids=["q-fp32", "q-bf16"])
def test_paged_bf16_pool(q_dtype, tol):
    """A bf16 pool read into fp32; with an fp32 query the result is held at
    fp32 tolerance, with a bf16 query at bf16's."""
    _assert_paged(_paged_case(3, batch=2, heads=4, kvh=2, hd=16, bs=4,
                              n_table=4), tol, q_dtype=q_dtype,
                  pool_dtype="bf16")


def test_paged_sentinel_hole_inside_window():
    q, kp, vp, table, pos = _paged_case(19, batch=2, heads=4, kvh=2, hd=8,
                                        bs=4, n_table=4)
    table[0, 1] = kp.shape[0]  # a hole inside slot 0's window
    pos[0] = 14
    y = _assert_paged((q, kp, vp, table, pos))
    full = table.copy()
    full[0, 1] = 1
    y_full, _, _ = _paged_both(q, kp, vp, full, pos)
    assert not np.allclose(y[0], y_full[0])


def test_paged_fully_masked_slot_gives_zeros():
    q, kp, vp, table, pos = _paged_case(23, batch=2, heads=4, kvh=2, hd=8,
                                        bs=4, n_table=3)
    table[1] = kp.shape[0]
    y = _assert_paged((q, kp, vp, table, pos))
    assert (y[1] == 0.0).all()


def test_paged_frozen_cache_full_slot():
    """A slot frozen at pos == max_table * bs attends its whole table and
    nothing past it."""
    q, kp, vp, table, pos = _paged_case(29, batch=2, heads=4, kvh=2, hd=8,
                                        bs=4, n_table=3)
    table[0] = np.arange(3)
    pos[0] = 12
    _assert_paged((q, kp, vp, table, pos))


@pytest.mark.parametrize("seed", range(6))
def test_paged_random_layouts(seed):
    rng = np.random.default_rng(100 + seed)
    heads, kvh = [(1, 1), (2, 1), (4, 2), (4, 4), (6, 3)][
        int(rng.integers(0, 5))]
    _assert_paged(_paged_case(
        int(rng.integers(0, 2**31)), batch=int(rng.integers(1, 5)),
        heads=heads, kvh=kvh, hd=int(rng.choice([4, 8, 16])),
        bs=int(rng.integers(1, 9)), n_table=int(rng.integers(1, 7)),
        extra_blocks=int(rng.integers(0, 4))))


# ---- chunk prefill: plain version vs the JAX kernel and oracle --------------


@pytest.mark.parametrize("heads,kvh", [(4, 4), (4, 2), (4, 1), (1, 1)])
def test_chunk_head_ratios(heads, kvh):
    _assert_chunk(_chunk_case(7, heads=heads, kvh=kvh, hd=16, bs=4,
                              n_table=5, w=8, offset=6, n_valid=8))


@pytest.mark.parametrize("kw", [
    dict(seed=11, bs=4, n_table=6, w=4, offset=8, n_valid=4),   # boundary
    dict(seed=13, bs=4, n_table=4, w=8, offset=0, n_valid=8),   # first
    dict(seed=17, bs=4, n_table=4, w=8, offset=0, n_valid=3),   # short
    dict(seed=19, bs=4, n_table=6, w=8, offset=7, n_valid=8),   # resume
    dict(seed=23, bs=1, n_table=8, w=4, offset=5, n_valid=1),   # one row
], ids=["chunk-boundary", "first-chunk", "prompt-shorter-than-chunk",
        "prefix-hit-resume-mid-block", "single-valid-row-bs1"])
def test_chunk_cases(kw):
    seed = kw.pop("seed")
    heads, kvh = (2, 1) if kw["bs"] == 1 else (4, 2)
    _assert_chunk(_chunk_case(seed, heads=heads, kvh=kvh, hd=8, **kw))


def test_chunk_bf16_pool():
    _assert_chunk(_chunk_case(3, heads=4, kvh=2, hd=16, bs=4, n_table=4, w=8,
                              offset=6, n_valid=8), pool_dtype="bf16")


def test_chunk_fully_padded_is_finite_zeros():
    q, kp, vp, table, kc, vc, off, nv = _chunk_case(
        29, heads=4, kvh=2, hd=8, bs=4, n_table=4, w=4, offset=0, n_valid=0)
    y = chunk_attention(_t(q), _t(kp), _t(vp), _t(table), _t(kc), _t(vc),
                        off, nv)
    assert torch.isfinite(y).all() and not y.any()


def test_chunk_sentinel_hole_in_prefix():
    q, kp, vp, table, kc, vc, off, nv = _chunk_case(
        31, heads=4, kvh=2, hd=8, bs=4, n_table=4, w=4, offset=12,
        n_valid=4)
    table[1] = kp.shape[0]  # a hole at positions 4..7
    y = _assert_chunk((q, kp, vp, table, kc, vc, off, nv))
    full = table.copy()
    full[1] = 0
    y_full = chunk_attention(_t(q), _t(kp), _t(vp), _t(full), _t(kc),
                             _t(vc), off, nv)
    assert not np.allclose(y, y_full.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_chunk_random_cases(seed):
    rng = np.random.default_rng(200 + seed)
    heads, kvh = [(1, 1), (2, 1), (4, 2), (4, 4), (6, 3)][
        int(rng.integers(0, 5))]
    bs, n_table, w = (int(rng.integers(1, 9)), int(rng.integers(1, 7)),
                      int(rng.integers(1, 9)))
    cap = n_table * bs
    offset = int(rng.integers(0, max(cap - w, 0) + 1))
    n_valid = int(rng.integers(0, min(w, cap - offset) + 1))
    _assert_chunk(_chunk_case(
        int(rng.integers(0, 2**31)), heads=heads, kvh=kvh,
        hd=int(rng.choice([4, 8, 16])), bs=bs, n_table=n_table, w=w,
        offset=offset, n_valid=n_valid,
        extra_blocks=int(rng.integers(0, 4))))


# ---- the layer: Attention.decode / prefill_chunk ----------------------------

DIM, HEADS, KVH, HD, BS, N_TABLE, N_BLOCKS = 32, 4, 2, 8, 4, 4, 9


def _layers():
    """(JAX Attention, port Attention) with the same weights and biases."""
    ja = JaxAttention.create(jax.random.PRNGKey(7), DIM, HEADS, KVH,
                             head_dim=HD, qkv_bias=True, dtype=jnp.float32)
    rng = np.random.default_rng(8)
    ja = ja.replace(**{n: getattr(ja, n).replace(bias=jnp.asarray(
        0.1 * rng.standard_normal(getattr(ja, n).bias.shape), jnp.float32))
        for n in ("q_proj", "k_proj", "v_proj")})

    def lin(m):
        return Linear(bridge.to_tensor(m.weight), None if m.bias is None
                      else bridge.to_tensor(m.bias))

    ta = Attention(lin(ja.q_proj), lin(ja.k_proj), lin(ja.v_proj),
                   lin(ja.o_proj), num_heads=HEADS, num_kv_heads=KVH,
                   head_dim=HD)
    return ja, ta


def _layer_script():
    """Slot 1 prefills 11 tokens in chunks of 4 (the last one ragged), slot 0
    holds 3 tokens; then three decode steps of both slots."""
    rng = np.random.default_rng(3)
    table = np.full((2, N_TABLE), N_BLOCKS, np.int32)
    table[1] = [5, 2, 7, 0]
    table[0, :2] = [4, 6]  # every position the script writes is mapped
    chunks = []
    for slot, plen in ((0, 3), (1, 11)):
        x = rng.standard_normal((1, plen, DIM)).astype(np.float32)
        for off in range(0, plen, 4):
            n = min(4, plen - off)
            span = np.zeros((1, 4, DIM), np.float32)
            span[:, :n] = x[:, off:off + n]
            p = off + np.arange(4)
            dst = np.where(np.arange(4) < n,
                           table[slot, p // BS] * BS + p % BS,
                           N_BLOCKS * BS).astype(np.int32)
            chunks.append((slot, off, n, span, dst))
    steps = [rng.standard_normal((2, 1, DIM)).astype(np.float32)
             for _ in range(3)]
    return table, chunks, steps


def _run_port_layer(attn, kernel, table, chunks, steps):
    cache = PagedKVCache(k=torch.zeros(N_BLOCKS, BS, KVH, HD),
                         v=torch.zeros(N_BLOCKS, BS, KVH, HD),
                         table=_t(table),
                         length=torch.zeros(2, dtype=torch.int32))
    outs = []
    for slot, off, n, span, dst in chunks:
        out, cache = attn.prefill_chunk(_t(span), cache, slot=slot,
                                        offset=off, n_valid=n, dst=_t(dst),
                                        prefill_kernel=kernel)
        outs.append(out[0, :n].numpy())
    for x in steps:
        out, cache = attn.decode(_t(x), cache, decode_kernel=kernel)
        outs.append(out.numpy())
    return outs, cache


def _run_jax_layer(attn, table, chunks, steps):
    cache = JaxPagedKVCache(k=jnp.zeros((N_BLOCKS, BS, KVH, HD)),
                            v=jnp.zeros((N_BLOCKS, BS, KVH, HD)),
                            table=jnp.asarray(table),
                            length=jnp.zeros((2,), jnp.int32))
    outs = []
    for slot, off, n, span, dst in chunks:
        out, cache = attn.prefill_chunk(
            jnp.asarray(span), cache, slot=jnp.int32(slot),
            offset=jnp.int32(off), n_valid=jnp.int32(n), dst=jnp.asarray(dst),
            prefill_kernel="pallas")
        outs.append(np.asarray(out)[0, :n])
    for x in steps:
        out, cache = attn.decode(jnp.asarray(x), cache,
                                 decode_kernel="pallas")
        outs.append(np.asarray(out))
    return outs, cache


def test_layer_cuda_matches_reference_and_jax_pallas():
    ja, ta = _layers()
    table, chunks, steps = _layer_script()
    kern, kcache = _run_port_layer(ta, "cuda", table, chunks, steps)
    ref, rcache = _run_port_layer(ta, "reference", table, chunks, steps)
    jout, jcache = _run_jax_layer(ja, table, chunks, steps)
    assert len(kern) == len(ref) == len(jout) == len(chunks) + len(steps)
    for k, r, j in zip(kern, ref, jout):
        np.testing.assert_allclose(k, r, err_msg="cuda vs reference", **TOL)
        np.testing.assert_allclose(k, j, err_msg="cuda vs JAX pallas", **TOL)
    # the writes do not depend on the attention kernel
    assert torch.equal(kcache.k, rcache.k) and torch.equal(kcache.v, rcache.v)
    np.testing.assert_allclose(kcache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(kcache.v.numpy(), np.asarray(jcache.v), **TOL)
    np.testing.assert_array_equal(kcache.length.numpy(),
                                  np.asarray(jcache.length))


@pytest.mark.parametrize("knob", ["decode_kernel", "prefill_kernel"])
def test_layer_refuses_unknown_kernel(knob):
    _, ta = _layers()
    table, chunks, steps = _layer_script()
    with pytest.raises(ValueError, match="reference.*cuda"):
        _run_port_layer(ta, "pallas", table, chunks[:1] if knob ==
                        "prefill_kernel" else [], steps)


# ---- the engine -------------------------------------------------------------

MAX_LEN, MAX_PROMPT, BATCH, CHUNK = 48, 24, 3, 8
KERNELS_ON = dict(decode_kernel="cuda", prefill_kernel="cuda")


@pytest.fixture(scope="module")
def models():
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
def test_engine_kernels_match_jax_pallas_engine_and_generate(models, kind):
    jc, tc, jmodels = models
    jmodel = jmodels[kind]
    kw = dict(seed=21, load=0.8, min_prompt=2, max_prompt=MAX_PROMPT - 9,
              min_new=2, max_new=6, vocab=jc.vocab, shared_prefix=9)
    jtrace, ttrace = jax_make_trace(6, **kw), make_trace(6, **kw)
    dims = dict(batch=BATCH, max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                block_size=4, chunk_size=CHUNK)
    jeng = JaxEngine(jmodel, jc, decode_kernel="pallas",
                     prefill_kernel="pallas", **dims)
    jdone, _ = jax_replay(jeng, jtrace)
    teng = ContinuousEngine(_port(jmodel, tc), tc, **KERNELS_ON, **dims)
    tdone, _ = replay(teng, ttrace)
    assert teng.kv_stats()["decode_kernel"] == "cuda"
    assert teng.prefill_stats()["prefill_kernel"] == "cuda"
    assert teng.kv_stats()["prefix_hit_tokens"] > 0
    assert len(tdone) == len(jdone) == 6
    for (_, req), jd, td in zip(ttrace, jdone, tdone):
        assert td.tokens == jd.tokens, (req.prompt.size, td.tokens,
                                        jd.tokens)
        assert td.tokens == _generate(jmodel, jc, req.prompt,
                                      req.max_new_tokens)
    assert teng.manager.allocator.n_in_use == 0


def test_engine_kernels_through_the_cache_full_frozen_slot(models):
    """A slot frozen at pos == max_len keeps attending its whole table
    and writes nowhere; its neighbour's tokens are untouched."""
    jc, tc, jmodels = models
    jmodel = jmodels["dense"]
    rng = np.random.default_rng(7)
    long_lived = rng.integers(0, jc.vocab, 4).astype(np.int32)
    filler = rng.integers(0, jc.vocab, 6).astype(np.int32)
    dims = dict(batch=2, max_len=16, max_prompt_len=8, block_size=4)
    outs = {}
    port = _port(jmodel, tc)
    for name, eng in (
            ("jax", JaxEngine(jmodel, jc, decode_kernel="pallas",
                              prefill_kernel="pallas", **dims)),
            ("reference", ContinuousEngine(port, tc, **dims)),
            ("cuda", ContinuousEngine(port, tc, **KERNELS_ON, **dims))):
        eng.submit(long_lived, max_new_tokens=12)
        eng.submit(filler, max_new_tokens=16)
        outs[name] = {c.prompt_len: c for c in eng.run()}
    assert outs["cuda"][6].finish_reason == "cache_full"
    for plen in (4, 6):
        assert (outs["cuda"][plen].tokens == outs["reference"][plen].tokens
                == outs["jax"][plen].tokens)


# ---- the wrappers -----------------------------------------------------------


def _small_paged():
    q, kp, vp, table, pos = _paged_case(1, batch=2, heads=4, kvh=2, hd=8,
                                        bs=4, n_table=3)
    return [_t(a) for a in (q, kp, vp, table, pos)]


def _small_chunk():
    q, kp, vp, table, kc, vc, off, nv = _chunk_case(
        1, heads=4, kvh=2, hd=8, bs=4, n_table=3, w=4, offset=4, n_valid=4)
    return [_t(a) for a in (q, kp, vp, table, kc, vc)] + [off, nv]


def _with(args, i, value):
    args = list(args)
    args[i] = value
    return args


@pytest.mark.parametrize("which,i,bad,exc,match", [
    ("paged", 0, lambda a: a[:, :3], ValueError, "kv_heads"),
    ("paged", 2, lambda a: a[..., :4], ValueError, "mismatch"),
    ("paged", 4, lambda a: a[:1], ValueError, "batch"),
    ("paged", 0, lambda a: a.half(), TypeError, "float32 or bfloat16"),
    ("paged", 3, lambda a: a.long(), TypeError, "int32"),
    ("paged", 2, lambda a: a.bfloat16(), TypeError, "the pool is"),
    ("paged", 1, lambda a: a.to("meta"), ValueError, "device of q"),
    ("chunk", 0, lambda a: a[:, :3], ValueError, "kv_heads"),
    ("chunk", 4, lambda a: a[:2], ValueError, "chunk K/V"),
    ("chunk", 3, lambda a: a[None], ValueError, "ONE slot"),
    ("chunk", 5, lambda a: a.double(), TypeError, "the pool is"),
    ("chunk", 1, lambda a: a.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError, "contiguous"),
    ("chunk", 4, lambda a: a.to("meta"), ValueError, "device of q"),
])
def test_wrappers_refuse_bad_inputs(which, i, bad, exc, match):
    fn, args = ((paged_attention, _small_paged()) if which == "paged"
                else (chunk_attention, _small_chunk()))
    with pytest.raises(exc, match=match):
        fn(*_with(args, i, bad(args[i])))


def test_wrappers_refuse_head_dim_past_the_kernels_limit():
    q = torch.zeros(1, 2, 264)
    kp = torch.zeros(2, 4, 1, 264)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        paged_attention(q, kp, kp, torch.zeros(1, 2, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="head_dim <= 256"):
        chunk_attention(q, kp, kp, torch.zeros(2, dtype=torch.int32),
                        kp[0, :1], kp[0, :1], 0, 1)


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    before = (paged_attention.launches, chunk_attention.launches)
    p, c = _small_paged(), _small_chunk()
    assert torch.equal(paged_attention(*p), paged_attention_torch(*p))
    assert torch.equal(chunk_attention(*c), chunk_attention_torch(*c))
    assert (paged_attention.launches, chunk_attention.launches) == before


def test_mask_fill_value_is_one_constant():
    assert NEG_INF == _paged.NEG_INF == JAX_NEG_INF


@pytest.mark.parametrize("name", ["paged_attention", "chunk_attention"])
def test_cuda_sources_exist_and_stand_alone(name):
    """Hand-written CUDA C++ with a plain C launcher, no library kernel."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    header = (ROOT / "src" / "repro_torch" / "csrc"
              / "attention_common.cuh").read_text()
    assert f'extern "C" int {name}_launch(' in src
    assert f"src/repro/kernels/{name}.py" in src  # names what it replaces
    assert '#include "attention_common.cuh"' in src
    for text in (src, header):
        low = text.lower()
        assert not any(lib in low for lib in (
            "cublas", "cudnn", "scaled_dot_product", "torch/", "cutlass"))
