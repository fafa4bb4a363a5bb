"""Port parity at the model level: ``auto_fact`` and the paged
``TransformerLM.prefill_chunk`` + ``decode`` path, held against the JAX
package with the same weights (carried by ``repro_torch.bridge``) and the
same numpy inputs, fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.core import auto_fact as jax_auto_fact
from repro.models import build_model
from repro.nn.module import named_parameters as jax_named_parameters

import repro_torch.configs as tcfg
from repro_torch import bridge
from repro_torch.core import auto_fact
from repro_torch.nn.linear import LED

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _params(jmodel):
    return {k: np.asarray(v) for k, v in jax_named_parameters(jmodel)}


def _perturbed(jmodel, seed):
    """Give norm scales and biases (ones and zeros at init) random values,
    so the parity checks see them."""
    rng = np.random.default_rng(seed)
    pairs, treedef = jax.tree_util.tree_flatten_with_path(jmodel)
    leaves = []
    for path, leaf in pairs:
        name = getattr(path[-1], "name", "")
        if name in ("scale", "bias"):
            leaf = leaf + jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                                      leaf.dtype)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module", params=["paper-tiny", "qwen2.5-3b"])
def dense(request):
    cfg = jcfg.get_config(request.param).reduced()
    jmodel = _perturbed(build_model(jax.random.PRNGKey(0), cfg), seed=1)
    return cfg, tcfg.get_config(request.param).reduced(), jmodel


# ---- auto_fact ----------------------------------------------------------------


@pytest.mark.parametrize("rank,gate", [(0.5, False), (0.25, True),
                                       (1.0, False), (5, True)])
def test_auto_fact_svd_matches_jax(dense, rank, gate):
    """Same report (paths, m, n, ranks, skips, params), the same ``A @ B``
    per layer and the same ``rel_err``; never ``A``/``B`` themselves (SVD
    factors are unique only up to sign)."""
    jc, tc, jmodel = dense
    jfact, jrep = jax_auto_fact(jmodel, rank, solver="svd",
                                exclude=["embed", "lm_head"], gate=gate,
                                return_report=True)
    port = bridge.from_jax(_params(jmodel), tc, device="cpu")
    port, trep = auto_fact(port, rank, solver="svd",
                           exclude=["embed", "lm_head"], gate=gate,
                           return_report=True)
    assert [e[:5] for e in trep.entries] == [e[:5] for e in jrep.entries]
    np.testing.assert_allclose([e[5] for e in trep.entries],
                               [e[5] for e in jrep.entries],
                               rtol=1e-4, atol=1e-6)
    assert trep.skipped == jrep.skipped
    assert (trep.params_before, trep.params_after) == (jrep.params_before,
                                                       jrep.params_after)
    assert trep.summary().splitlines()[0] == jrep.summary().splitlines()[0]
    jp = _params(jfact)
    tp = dict(bridge.named_parameters(port))
    for path, *_ in jrep.entries:
        ja = jp[f"{path}.A"] @ jp[f"{path}.B"]
        ta = (tp[f"{path}.A"] @ tp[f"{path}.B"]).numpy()
        np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-5)
        if f"{path}.bias" in jp:
            np.testing.assert_array_equal(tp[f"{path}.bias"].numpy(),
                                          jp[f"{path}.bias"])


def test_auto_fact_random_solver_shapes_and_generator():
    tc = tcfg.get_config("paper-tiny").reduced()
    port = bridge.from_jax(_params(build_model(jax.random.PRNGKey(0),
                                               jcfg.get_config("paper-tiny")
                                               .reduced())), tc, device="cpu")
    g = torch.Generator().manual_seed(5)
    port, rep = auto_fact(port, 0.5, solver="random", generator=g,
                          exclude=["embed", "lm_head"], gate=False,
                          return_report=True)
    leds = [m for m in port.modules() if isinstance(m, LED)]
    assert len(leds) == 7 * tc.n_layers
    q = port.blocks[0].attn.q_proj
    assert tuple(q.A.shape) == (64, 32) and tuple(q.B.shape) == (32, 64)
    # lecun-style scaling: var(A) ~ 1/m, var(B) ~ 1/r
    assert abs(q.A.float().var().item() * 64 - 1) < 0.3
    assert all(0.5 < e[5] for e in rep.entries)  # does not approximate W
    with pytest.raises(ValueError, match="unknown solver"):
        auto_fact(port, 0.5, solver="snmf")


# ---- prefill_chunk + paged decode --------------------------------------------

B, BS, MAX_LEN = 2, 4, 32
N_BLOCKS = B * (MAX_LEN // BS)
SENT = N_BLOCKS


def _scenario(vocab, seed=0):
    """Two slots: slot 0 prefills 11 tokens in chunks of 8+3 (padded to 8
    and 4), slot 1 prefills 5 tokens padded to 8; then 3 decode steps."""
    rng = np.random.default_rng(seed)
    table = np.full((B, MAX_LEN // BS), SENT, np.int32)
    table[0], table[1] = np.arange(8), np.arange(8, 16)[::-1]
    chunks = []  # (slot, offset, tokens (1, W), n_valid, dst (W,))
    for slot, plen, widths in ((0, 11, (8, 4)), (1, 5, (8,))):
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        off = 0
        for w in widths:
            n = min(w, plen - off)
            toks = np.zeros((1, w), np.int32)
            toks[0, :n] = prompt[off:off + n]
            p = off + np.arange(w)
            dst = np.where(p < plen, table[slot, p // BS] * BS + p % BS,
                           SENT * BS).astype(np.int32)
            chunks.append((slot, off, toks, n, dst))
            off += n
    steps = [rng.integers(0, vocab, (B, 1)).astype(np.int32)
             for _ in range(3)]
    return table, chunks, steps


def _run_jax(jmodel, cfg, table, chunks, steps):
    cache = jmodel.init_paged_cache(B, MAX_LEN, cfg, n_blocks=N_BLOCKS,
                                    block_size=BS, dtype=jnp.float32)
    cache = cache._replace(table=jnp.asarray(table))
    out = []
    for slot, off, toks, n, dst in chunks:
        logits, cache = jmodel.prefill_chunk(
            jnp.asarray(toks), cache, slot=jnp.int32(slot),
            offset=jnp.int32(off), n_valid=jnp.int32(n),
            dst=jnp.asarray(dst))
        out.append(np.asarray(logits))
    for tok in steps:
        logits, cache = jmodel.decode(jnp.asarray(tok), cache)
        out.append(np.asarray(logits))
    return out, cache


def _run_port(port, cfg, table, chunks, steps):
    cache = port.init_paged_cache(B, MAX_LEN, cfg, n_blocks=N_BLOCKS,
                                  block_size=BS, dtype=torch.float32)
    cache = cache._replace(table=torch.from_numpy(table))
    out = []
    for slot, off, toks, n, dst in chunks:
        logits, cache = port.prefill_chunk(
            torch.from_numpy(toks).long(), cache, slot=slot, offset=off,
            n_valid=n, dst=torch.from_numpy(dst))
        out.append(logits.numpy())
    for tok in steps:
        logits, cache = port.decode(torch.from_numpy(tok).long(), cache)
        out.append(logits.numpy())
    return out, cache


@pytest.mark.parametrize("factorized", [False, True])
def test_prefill_chunk_and_paged_decode_logits_match_jax(dense, factorized):
    jc, tc, jmodel = dense
    if factorized:
        jmodel = jax_auto_fact(jmodel, 0.5, solver="svd",
                               exclude=["embed", "lm_head"], gate=False)
    port = bridge.from_jax(_params(jmodel), tc, device="cpu")
    assert factorized == any(isinstance(m, LED) for m in port.modules())
    table, chunks, steps = _scenario(jc.vocab)
    jout, jcache = _run_jax(jmodel, jc, table, chunks, steps)
    tout, tcache = _run_port(port, tc, table, chunks, steps)
    assert len(jout) == len(tout) == 6
    for j, t in zip(jout, tout):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, **LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(),
                                  np.asarray(jcache.length))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **LOGIT_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **LOGIT_TOL)


def test_decode_drops_writes_of_parked_and_unmapped_slots(dense):
    """A slot parked at pos == max_table*bs and a slot whose table is all
    sentinel write nowhere (JAX's mode='drop'), and the pool stays
    untouched."""
    jc, tc, jmodel = dense
    port = bridge.from_jax(_params(jmodel), tc, device="cpu")
    cache = port.init_paged_cache(B, MAX_LEN, tc, n_blocks=N_BLOCKS,
                                  block_size=BS, dtype=torch.float32)
    table = np.full((B, MAX_LEN // BS), SENT, np.int32)
    table[0] = np.arange(8)
    park = np.array([MAX_LEN, 3], np.int32)  # slot 0 parked, slot 1 unmapped
    cache = cache._replace(
        table=torch.from_numpy(table),
        length=torch.from_numpy(np.tile(park, (tc.n_layers, 1))))
    logits, new = port.decode(torch.tensor([[1], [2]]), cache)
    assert torch.isfinite(logits).all()
    assert not new.k.any() and not new.v.any()
    jcache = jmodel.init_paged_cache(B, MAX_LEN, jc, n_blocks=N_BLOCKS,
                                     block_size=BS, dtype=jnp.float32)
    jcache = jcache._replace(table=jnp.asarray(table),
                             length=jnp.asarray(np.tile(park,
                                                        (jc.n_layers, 1))))
    jlogits, _ = jmodel.decode(jnp.asarray([[1], [2]]), jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
