"""``repro_torch/core/vbi/kvcache.py`` against ``repro/core/vbi/
kvcache.py``: one random sequence of admit / release / reserve+write ops,
driven with the same numpy inputs on both, leaves every field of the
state equal after every op — exactly, since these are integer ops and
copies.  Page 0's payload is excluded: masked-out slots all write into
the null page in no defined order, and it is never attended."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vbi import kvcache as jk
from repro_torch.core.vbi import kvcache as tk

FIELDS = [f.name for f in dataclasses.fields(tk.PagedServeState)]


def _assert_same(js, ts, where=""):
    for name in FIELDS:
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        if name in ("k_pages", "v_pages"):
            a, b = a[:, 1:], b[:, 1:]
        assert a.shape == b.shape and a.dtype == b.dtype, (name, where)
        np.testing.assert_array_equal(b, a, err_msg=f"{name} {where}")


def _states(**kw):
    return jk.init_serve_state(**kw), tk.init_serve_state(device="cpu", **kw)


def test_init_serve_state_fields_and_helpers():
    kw = dict(n_layers=2, n_pages=9, page_size=2, n_kv=2, head_dim=4,
              max_seqs=3, max_pages_per_seq=4, n_ring_layers=1,
              ring_pages=2, n_rg=1, rnn_width=5, n_ssm=1, ssm_heads=2,
              ssm_proj=3, ssm_state_size=4, ssm_conv_ch=6)
    js, ts = _states(**kw)
    _assert_same(js, ts)
    assert tk.tier_nbytes(ts) == jk.tier_nbytes(js)
    assert (ts.free_stack.tolist() == list(range(1, 10))
            and int(ts.free_top) == 8)
    for n, rp in ((3, 0), (3, 2), (1, 4)):
        np.testing.assert_array_equal(tk.make_ring_table(n, rp),
                                      jk.make_ring_table(n, rp))
    for args in ((0, 0, 0), (2, 3, 0), (0, 0, 2), (1, 2, 1)):
        assert tk.aux_swap_charge(*args) == jk.aux_swap_charge(*args)


@pytest.mark.parametrize("seed", range(4))
def test_random_op_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    L, n_pages, ps, n_kv, hd, S, P = 2, 12, 2, 2, 4, 3, 4
    js, ts = _states(n_layers=L, n_pages=n_pages, page_size=ps, n_kv=n_kv,
                     head_dim=hd, max_seqs=S, max_pages_per_seq=P)
    active = set()
    lens = np.zeros(S, int)
    free = n_pages - 1                    # host mirror of the free stack
    for step in range(40):
        op = rng.choice(["admit", "release", "token", "token", "token"])
        if op == "admit" and len(active) < S:
            s = int(rng.choice([x for x in range(S) if x not in active]))
            js = jk.admit_slot(js, jnp.int32(s))
            tk.admit_slot(ts, s)
            active.add(s)
            lens[s] = 0
        elif op == "release" and active:
            s = int(rng.choice(sorted(active)))
            js = jk.release_slot(js, jnp.int32(s))
            tk.release_slot(ts, s)
            active.discard(s)
            free += -(-lens[s] // ps)
            lens[s] = 0
        else:
            cand = [s for s in sorted(active) if lens[s] < P * ps]
            mask = np.zeros(S, bool)
            for s in cand:
                if rng.random() < 0.7:
                    mask[s] = True
            pops = sum(1 for s in range(S) if mask[s] and lens[s] % ps == 0)
            if pops > free:
                continue
            free -= pops
            js, jpos = jk.reserve_positions(js, jnp.asarray(mask))
            ts, tpos = tk.reserve_positions(ts, torch.from_numpy(mask))
            np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
            kv = rng.standard_normal((2, S, n_kv, hd)).astype(np.float32)
            layer = int(rng.integers(L))
            jkp, jvp = jk.write_token_kv(
                js.k_pages, js.v_pages, layer, js.page_table, jpos,
                jnp.asarray(mask), jnp.asarray(kv[0]), jnp.asarray(kv[1]))
            js = dataclasses.replace(js, k_pages=jkp, v_pages=jvp)
            tk.write_token_kv(ts.k_pages, ts.v_pages, layer, ts.page_table,
                              tpos, torch.from_numpy(mask),
                              torch.from_numpy(kv[0]),
                              torch.from_numpy(kv[1]))
            lens += mask
        _assert_same(js, ts, f"seed {seed} step {step} ({op})")
    # releasing an already-released slot is a no-op on both
    s = next(x for x in range(S) if x not in active) if len(active) < S \
        else None
    if s is not None:
        js = jk.release_slot(js, jnp.int32(s))
        tk.release_slot(ts, s)
        _assert_same(js, ts, "double release")


@pytest.mark.parametrize("eos_id", [-1, 5])
def test_fused_decode_scan_matches_reference(eos_id):
    """A deterministic stub step (next token = f(token, slot)) through both
    scans: same [K, S] block, -1 on masked lanes, EOS and budget stops."""
    S, K = 4, 6
    tokens = np.array([1, 2, 3, 4], np.int32)
    mask = np.array([True, True, False, True])
    steps = np.array([6, 2, 6, 4], np.int32)
    V = 8

    def j_step(state, toks, active):
        nxt = (toks * 3 + jnp.arange(S)) % V
        logits = jnp.where(jnp.arange(V)[None] == nxt[:, None], 1.0, 0.0)
        return logits[:, None], state + active.astype(jnp.int32)

    def t_step(state, toks, active):
        nxt = (toks * 3 + torch.arange(S)) % V
        logits = torch.where(torch.arange(V)[None] == nxt[:, None], 1.0, 0.0)
        return logits[:, None], state + active.to(torch.int32)

    jb, jst = jk.fused_decode_scan(j_step, jnp.zeros(S, jnp.int32),
                                   jnp.asarray(tokens), jnp.asarray(mask),
                                   jnp.asarray(steps), K, eos_id)
    tb, tst = tk.fused_decode_scan(t_step, torch.zeros(S, dtype=torch.int32),
                                   torch.from_numpy(tokens),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(steps), K, eos_id)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert (tb[:, 2] == -1).all() and (tb[2:, 1] == -1).all()
