"""The split B4 mega-decode kernel's host plan and its arithmetic order.

The CUDA kernel (``paddle_tpu_torch/kernels/csrc/mega_decode.cu``) runs
only on the card. What it computes on this CPU is checked two ways:
- the chunk planner (plain Python in the wrapper) covers the cache rows
  exactly once and fills the card's SMs;
- a numpy rehearsal, written here, of the kernel's order of operations:
  per chunk, row groups that each run an online softmax over batches of U
  rows (one rescale a batch), combined pairwise as the warp's xor
  shuffles combine them, then across warps, into one partial state per
  chunk; the last block's fold of the partials of the chunks that hold
  rows into the new row's state. Above 8 query heads a kv head, each
  sub-group of G heads (``md.sub_groups``) runs all of that on its own.
  It is held to ``mega_decode_step_plain`` (the f32 formula of
  paddle_tpu's ``_attend``; the JAX kernel itself is held to it in
  tests/test_torch_port_kernels.py and, at g = 3, 5 and 16, in
  tests/test_torch_port_llama.py).

Tolerance: ctx atol 1e-6 in f32 (the same sums taken in another order
over at most L = 192 rows of O(1) values); caches bit-exact; with no old
row (pos <= 0) ctx equals v bit for bit.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import mega_decode as md

WARPS = 4       # the kernel's kWarps


def _weight(m, M):
    """exp(m - M), 0 where m = -inf (the kernel's ``weight``)."""
    out = np.zeros_like(m)
    live = m != -np.inf
    out[live] = np.exp(m[live] - M[live])
    return out


def _combine(a, b):
    """Two (m [G], s [G], acc [G, hd]) states into one."""
    M = np.maximum(a[0], b[0])
    c1, c2 = _weight(a[0], M), _weight(b[0], M)
    return M, a[1] * c1 + b[1] * c2, a[2] * c1[:, None] + b[2] * c2[:, None]


def rehearse(q, k, v, kc, vc, pos, chunk, rpw, U):
    """The kernel's arithmetic in its order, in numpy f32. q [B,1,nh,hd],
    k/v [B,1,nkv,hd], kc/vc [B,L,nkv,hd] (written in place), pos [B];
    ``rpw`` row groups per warp, ``U`` rows per group per batch. Returns
    ctx [B,1,nh,hd]."""
    B, L, nkv, hd = kc.shape
    G, nsub = md.sub_groups(q.shape[2] // nkv)
    scale = np.float32(1.0 / np.sqrt(hd))
    nslots = WARPS * rpw
    nchunks = -(-L // chunk)
    ctx = np.zeros(q.shape, np.float32)
    empty = (np.full(G, -np.inf, np.float32), np.zeros(G, np.float32),
             np.zeros((G, hd), np.float32))
    for b in range(B):
        n_old = min(max(int(pos[b]), 0), L)
        for hs in range(nkv * nsub):      # (kv head, sub-group) blocks
            h = hs // nsub
            qh = q[b, 0, hs * G:(hs + 1) * G]                # [G, hd]
            partials = []
            for c in range(nchunks):
                r0, r1 = c * chunk, min((c + 1) * chunk, n_old)
                if r0 >= r1:
                    continue              # an empty block only counts
                states = [empty] * nslots
                for base in range(r0, r1, nslots * U):
                    for sl in range(nslots):
                        m, s, acc = states[sl]
                        rows = [base + u * nslots + sl for u in range(U)]
                        lg = np.stack([
                            (qh @ kc[b, r, h]) * scale if r < r1
                            else np.full(G, -np.inf, np.float32)
                            for r in rows])                   # [U, G]
                        m_new = np.maximum(m, lg.max(0))
                        corr = _weight(m, m_new)
                        s, acc = s * corr, acc * corr[:, None]
                        for u, r in enumerate(rows):
                            p = _weight(lg[u], m_new)
                            s = s + p
                            if r < r1:
                                acc = acc + p[:, None] * vc[b, r, h][None]
                        states[sl] = (m_new, s, acc)
                # the xor shuffles over a warp's row groups, all at once
                o = 1
                while o < rpw:
                    states = [_combine(states[i], states[i ^ o])
                              if i // rpw == (i ^ o) // rpw else states[i]
                              for i in range(nslots)]
                    o <<= 1
                warps = [states[w * rpw] for w in range(WARPS)]
                M = np.max([w[0] for w in warps], axis=0)
                wts = [_weight(w[0], M) for w in warps]
                partials.append((
                    M, sum(w[1] * t for w, t in zip(warps, wts)),
                    sum(w[2] * t[:, None] for w, t in zip(warps, wts))))
            assert len(partials) == -(-n_old // chunk)
            # the last block folds them, in chunk order, into the new row
            M = (qh @ k[b, 0, h]) * scale
            den = np.ones(G, np.float32)
            num = np.repeat(v[b, 0, h][None], G, axis=0)
            for pm, ps, pa in partials:
                M2 = np.maximum(M, pm)
                c1, c2 = np.exp(M - M2), _weight(pm, M2)
                den = den * c1 + ps * c2
                num = num * c1[:, None] + pa * c2[:, None]
                M = M2
            ctx[b, 0, hs * G:(hs + 1) * G] = num / den[:, None]
        if 0 <= pos[b] < L:
            kc[b, pos[b]] = k[b, 0]
            vc[b, pos[b]] = v[b, 0]
    return ctx


@pytest.mark.parametrize("B,nkv,L,sms", [
    (8, 12, 1024, 132), (1, 1, 1, 132), (1, 1, 63, 132), (2, 4, 4096, 132),
    (64, 32, 1024, 132), (8, 12, 1000, 114), (1, 1, 100000, 132),
    (3, 5, 777, 16)])
def test_plan_chunks_covers_the_cache_once(B, nkv, L, sms):
    chunk, n = md.plan_chunks(B, nkv, L, sms)
    rows = np.concatenate([np.arange(c * chunk, min((c + 1) * chunk, L))
                           for c in range(n)])
    np.testing.assert_array_equal(rows, np.arange(L))
    assert (n - 1) * chunk < L <= n * chunk           # no chunk is empty
    assert chunk % md._CHUNK_ROWS == 0 and 1 <= n <= md._MAX_CHUNKS
    for g, hd in ((1, 64), (8, 36)):
        assert md.workspace_floats(B, nkv, n, g, hd) == \
            B * nkv * n * g * (2 + hd)
    if (B, nkv, L, sms) == (8, 12, 1024, 132):
        assert B * nkv * n >= 2 * sms                 # the card twice over


@pytest.mark.parametrize("g,want", [
    (1, (1, 1)), (3, (3, 1)), (5, (5, 1)), (7, (7, 1)), (8, (8, 1)),
    (12, (6, 2)), (16, (8, 2)), (11, (1, 11)), (40, (8, 5)),
    (64, (8, 8))])
def test_sub_groups_split_every_group_count(g, want):
    """Every g >= 1 splits into sub-groups of at most 8 heads that cover
    it exactly (MQA at 40 and 64 heads included)."""
    G, nsub = md.sub_groups(g)
    assert (G, nsub) == want and G * nsub == g and 1 <= G <= 8


def test_c_entry_matches_signature_table():
    """The ctypes table declares the C entry's parameter count."""
    import re
    from pathlib import Path
    text = (Path(md.__file__).parent / "csrc" / "mega_decode.cu").read_text()
    (params,) = re.findall(r'extern "C" int mega_decode_launch\(([^)]*)\)',
                           text)
    restype, argtypes = md._SIGNATURES["mega_decode_launch"]
    assert len(argtypes) == params.count(",") + 1
    for g in range(1, 9):                   # every G the wrapper may pass
        assert f"case {g}: return launch_g<TC, {g}>" in text


@pytest.mark.parametrize("rpw,u0", [(2, 4), (4, 8)])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8, 16])
def test_split_softmax_rehearsal_matches_plain(g, rpw, u0):
    """rpw 4, U 8: a bf16 cache at hd 64 (8 lanes a row, 16-byte loads);
    rpw 2, U 4: f32 at hd 64. Above G = 2 the kernel takes U = 2 U0 / G
    rows (at least 1); g = 16 runs as two sub-groups of 8."""
    nkv, L, hd = 2, 192, 64
    chunk, n = md.plan_chunks(8, nkv, L, 132)
    assert n == 3
    pos = np.asarray([-1, 0, 1, chunk - 1, chunk, L - 1, L, L + 7],
                     np.int32)
    rs = np.random.RandomState(g * 10 + rpw)
    B = len(pos)
    q = rs.randn(B, 1, nkv * g, hd).astype(np.float32)
    k, v = (rs.randn(B, 1, nkv, hd).astype(np.float32) for _ in range(2))
    kc, vc = (rs.randn(B, L, nkv, hd).astype(np.float32) for _ in range(2))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    want, _, _ = md.mega_decode_step_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tkc,
        tvc, torch.from_numpy(pos))
    G = md.sub_groups(g)[0]
    U = u0 if G <= 2 else max(2 * u0 // G, 1)
    got = rehearse(q, k, v, kc, vc, pos, chunk, rpw, U)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(kc, tkc.numpy())
    np.testing.assert_array_equal(vc, tvc.numpy())
    for b in np.nonzero(pos <= 0)[0]:                 # no old row: ctx = v
        np.testing.assert_array_equal(
            got[b, 0], np.repeat(v[b, 0], g, axis=0))
