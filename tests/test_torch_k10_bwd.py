"""K10's backward, the batch outer product H[d,e,f] = sum_b G[b,d,f]
conj(vf[b,e,f0+f]): the host side of its kernel (``fourier.bwd_tile``,
which picks the tile of frequencies and the chunk of batch rows, and
what the wrapper passes), a float64 mirror of the kernel's staged order
of operations, and the port's gradient through the 'slfm' contraction,
with the mirror as its backward, against the JAX package's autodiff of
the same einsums, on the CPU."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu_torch.hopper import build, fourier
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.parallel.mesh import shard_range

# the same few-term contractions and FFTs (pocketfft on both sides)
RTOL = 1e-12
# the weather group's backward: 16 batch rows, D = 4, F = 4097
WEATHER = (16, 4, 4097)
DTYPES = (torch.complex64, torch.complex128)


def _widths(F):
    """The full range and both ranges of two of F frequencies."""
    return [F] + [hi - lo for lo, hi in (shard_range(F, 2, r)
                                         for r in range(2))]


def _chunk(nb, D, tile, dtype):
    """The batch rows of an 8 KB stage at this tile, 1 to nb."""
    item = 16 if dtype == torch.complex128 else 8
    return max(1, min(nb, fourier.BWD_STAGE_BYTES // (2 * D * tile * item)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_bwd_tile_invariants(dtype, sms):
    """At the weather widths (the full range and both ranges of two) and
    every batch count and D: the tiles cover [0, nf) exactly once, a
    CTA's outputs fit its threads' running sums, every SM has a CTA, a
    chunk fills one stage, the ring fits the opt-in shared memory, and
    the result is a pure function of the shape."""
    for nf in _widths(WEATHER[2]):
        for nb in (1, 3, 16, 17, 128):
            for D in (1, 4, 9):
                tile, chunk = fourier.bwd_tile(nb, D, nf, dtype, sms=sms)
                assert [fourier.bwd_tile(nb, D, nf, dtype, sms=sms)
                        for _ in range(3)] == [(tile, chunk)] * 3
                assert tile in fourier.BWD_TILES
                assert D * D * tile <= fourier.BWD_SUMS * fourier.BWD_THREADS
                ctas = -(-nf // tile)
                assert ctas >= sms
                wider = [t for t in fourier.BWD_TILES if t > tile]
                assert all(-(-nf // t) < sms or D * D * t >
                           fourier.BWD_SUMS * fourier.BWD_THREADS
                           for t in wider)
                cover = np.zeros(nf, np.int64)
                for c in range(ctas):
                    cover[c * tile:min((c + 1) * tile, nf)] += 1
                assert (cover == 1).all()
                assert chunk == _chunk(nb, D, tile, dtype)
                smem = fourier.bwd_smem(nb, D, tile, chunk, dtype)
                assert smem <= fourier.BWD_STAGES * fourier.BWD_STAGE_BYTES
                assert smem <= fourier.BWD_SMEM_OPTIN


def test_bwd_tile_at_the_weather_shapes():
    """The weather group's tiles on an H100: in float64 16 frequencies
    (257 CTAs, two sums a thread) in 4 chunks of 4 rows at the full
    range and 8 (256 or 257 CTAs) in 2 chunks of 8 on either range of
    two; float32's chunks twice as deep. Past a CTA's sums the narrowest
    tile, its outputs over grid rows."""
    nb, D, F = WEATHER
    full, *ranges = _widths(F)
    assert fourier.bwd_tile(nb, D, full, torch.complex128) == (16, 4)
    assert fourier.bwd_tile(nb, D, full, torch.complex64) == (16, 8)
    for nf in ranges:
        assert fourier.bwd_tile(nb, D, nf, torch.complex128) == (8, 8)
        assert fourier.bwd_tile(nb, D, nf, torch.complex64) == (8, 16)
    assert fourier.bwd_tile(0, D, F, torch.complex128)[1] == 1
    assert fourier.bwd_tile(3, 12, 4097, torch.complex128) == (4, 3)
    tile, chunk = fourier.bwd_tile(64, 150, 4097, torch.complex128)
    assert (tile, chunk) == (1, 1)  # a row of 150 x 2 elements a buffer
    assert fourier.bwd_smem(64, 150, tile, chunk, torch.complex128) \
        <= fourier.BWD_STAGES * fourier.BWD_STAGE_BYTES


def _stub_card(monkeypatch, seen):
    """The wrapper's host path with the card's calls stubbed: each
    launch records its symbol and arguments."""
    def fake_function(name, symbol, argtypes):
        def fn(*args):
            seen.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(build, "use_plain", lambda what, t: False)
    monkeypatch.setattr(build, "require_cuda", lambda what, *ts: None)
    monkeypatch.setattr(build, "function", fake_function)
    monkeypatch.setattr(build, "stream_ptr", lambda device=None: "stream")
    monkeypatch.setattr(build, "sm_count", lambda index: build.H100_SMS)


def _cplx(rng, shape, dtype=torch.complex128):
    return torch.as_tensor(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape)).to(dtype)


def test_bwd_wrapper_passes_the_selector_and_the_range(monkeypatch):
    """fourier_contract_bwd passes bwd_tile's tile and chunk, f0, the
    operand's row length and the stream, and counts one launch a call."""
    seen = []
    _stub_card(monkeypatch, seen)
    rng = np.random.RandomState(11)
    nb, D, F = WEATHER
    before = dict(fourier.fourier_contract_bwd.launches)
    calls = []
    for dtype, sfx in ((torch.complex128, "f64"), (torch.complex64, "f32")):
        vf = _cplx(rng, (nb, D, F), dtype)
        for f0, f1 in [(0, F)] + [shard_range(F, 2, r) for r in range(2)]:
            G = _cplx(rng, (nb, D, f1 - f0), dtype)
            H = fourier.fourier_contract_bwd(G, vf, f0=f0)
            assert H.shape == (D, D, f1 - f0) and H.dtype == dtype
            tile, chunk = fourier.bwd_tile(nb, D, f1 - f0, dtype)
            calls.append(("fourier_bwd_" + sfx, G.data_ptr(), vf.data_ptr(),
                          H.data_ptr(),
                          (nb, D, f1 - f0, f0, F, tile, chunk, "stream")))
    got = [(s, a[0].value, a[1].value, a[2].value, a[3:]) for s, a in seen]
    assert got == calls
    assert fourier.fourier_contract_bwd.launches["f64"] == before["f64"] + 3
    assert fourier.fourier_contract_bwd.launches["f32"] == before["f32"] + 3
    # a large batch in chunks, and D past one grid row of sums
    seen.clear()
    fourier.fourier_contract_bwd(_cplx(rng, (128, 4, 33)),
                                 _cplx(rng, (128, 4, 33)))
    fourier.fourier_contract_bwd(_cplx(rng, (2, 40, 5)), _cplx(rng, (2, 40, 5)))
    assert [a[3:10] for _, a in seen] == [
        (128, 4, 33, 0, 33) + fourier.bwd_tile(128, 4, 33, torch.complex128),
        (2, 40, 5, 0, 5) + fourier.bwd_tile(2, 40, 5, torch.complex128)]


def test_bwd_wrapper_raises_on_mismatches(monkeypatch):
    seen = []
    _stub_card(monkeypatch, seen)
    rng = np.random.RandomState(12)
    vf = _cplx(rng, (5, 3, 33))
    with pytest.raises(ValueError, match="disagree"):
        fourier.fourier_contract_bwd(_cplx(rng, (4, 3, 33)), vf)
    with pytest.raises(ValueError, match="disagree"):
        fourier.fourier_contract_bwd(_cplx(rng, (5, 2, 33)), vf)
    with pytest.raises(ValueError, match="disagree"):
        fourier.fourier_contract_bwd(_cplx(rng, (5, 3, 33), torch.complex64),
                                     vf)
    with pytest.raises(ValueError, match="outside"):
        fourier.fourier_contract_bwd(_cplx(rng, (5, 3, 20)), vf, f0=14)
    with pytest.raises(ValueError, match="complex64 or complex128"):
        fourier.fourier_contract_bwd(torch.zeros(5, 3, 33, dtype=torch.float64),
                                     torch.zeros(5, 3, 33, dtype=torch.float64))
    # four chunks of one row of 1900 outputs pass the opt-in shared memory
    big = torch.zeros(4, 1900, 1, dtype=torch.complex128)
    assert fourier.bwd_smem(4, 1900, *fourier.bwd_tile(
        4, 1900, 1, big.dtype), big.dtype) > fourier.BWD_SMEM_OPTIN
    with pytest.raises(ValueError, match="shared memory"):
        fourier.fourier_contract_bwd(big, big)
    assert seen == []


def _cmulc(gr, gi, vr, vi):
    """g * conj(v) as the kernel's cmulc forms it."""
    return gr * vr + gi * vi, gi * vr - gr * vi


def staged_mirror(G, vf, f0, tile, chunk):
    """The backward kernel's walk in float64 on the CPU: for each CTA
    (a tile of frequencies, a grid row of outputs), the chunks of batch
    rows staged as the kernel lays them out (G's rows, then the
    operand's, each (b, d) row ``tile`` wide), and each thread's running
    sums (outputs t + k BWD_THREADS, (d D + e) tile + fl) over a stage's
    rows in ascending b; H stored at the kernel's index."""
    nb, D, nf = G.shape
    ldv = vf.shape[-1]
    T, S = fourier.BWD_THREADS, fourier.BWD_SUMS
    row, nout = D * tile, D * D * tile
    per_thread = -(-nout // T)
    sums = next(s for s in (1, 2, 4, S) if per_thread <= s or s == S)
    groups = -(-nout // (sums * T))
    Gf = torch.view_as_real(G.contiguous()).reshape(-1, 2)
    vff = torch.view_as_real(vf.contiguous()).reshape(-1, 2)
    H = torch.full((D * D * nf, 2), float("nan"), dtype=torch.float64)
    t = torch.arange(T)
    for bx in range(-(-nf // tile)):
        fb = bx * tile
        tw = min(tile, nf - fb)
        for by in range(groups):
            o = (by * sums * T + t[:, None] + T * torch.arange(sums)).ravel()
            de, fl = o // tile, o % tile
            d, e = de // D, de % D
            live = (o < nout) & (fl < tw)
            goff = (d * tile + fl)[live]
            voff = (chunk * row + e * tile + fl)[live]
            acc = torch.zeros((int(live.sum()), 2), dtype=torch.float64)
            for c in range(-(-nb // chunk)):
                b0 = c * chunk
                stage = torch.full((2 * chunk * row, 2), float("nan"),
                                   dtype=torch.float64)
                i = torch.arange(min(chunk, nb - b0) * row)
                bd, il = i // tile, i % tile
                ok = il < tw
                grow = (b0 * D + bd) * nf + fb + il
                vrow = (b0 * D + bd) * ldv + f0 + fb + il
                stage[i[ok]] = Gf[grow[ok]]
                stage[chunk * row + i[ok]] = vff[vrow[ok]]
                for b in range(min(chunk, nb - b0)):
                    g = stage[b * row + goff]
                    v = stage[b * row + voff]
                    re, im = _cmulc(g[:, 0], g[:, 1], v[:, 0], v[:, 1])
                    acc = torch.stack([acc[:, 0] + re, acc[:, 1] + im], 1)
            H[(de * nf + fb + fl)[live]] = acc
    return torch.view_as_complex(H.reshape(D, D, nf, 2).contiguous())


def plain_loop(G, vf, f0):
    """Each output's sum over b from zero in ascending order, the
    cmulc products of the kernel's helpers."""
    nb, D, nf = G.shape
    v = vf[..., f0:f0 + nf]
    re = torch.zeros((D, D, nf), dtype=torch.float64)
    im = torch.zeros((D, D, nf), dtype=torch.float64)
    for b in range(nb):
        g, w = G[b][:, None, :], v[b][None, :, :]
        r, i = _cmulc(g.real, g.imag, w.real, w.imag)
        re, im = re + r, im + i
    return torch.complex(re, im)


@pytest.mark.parametrize("nb, D, F, nf, f0, sms, layout", [
    (32, 4, 37, 37, 0, 4, (8, 8)),      # the ring's four chunks, no refill
    (33, 4, 37, 37, 0, 4, (8, 8)),      # one past: a fifth refills a buffer
    (16, 4, 37, 37, 0, 3, (16, 4)),     # the weather full range's layout:
                                        # two sums a thread, 4 chunks
    (16, 4, 37, 37, 0, 2, (32, 2)),     # four sums, 8 chunks of 2
    (129, 4, 37, 19, 17, 4, (4, 16)),   # an odd range, ragged tile, 9 chunks
    (3, 9, 37, 37, 0, 4, (8, 3)),       # D = 9: eight sums a thread
    (5, 1, 23, 12, 11, 132, (1, 5)),    # D = 1, tile 1, one chunk
    (3, 33, 5, 3, 1, 132, (1, 3)),      # D^2 past a CTA's sums: 2 grid rows
])
def test_staged_mirror_is_the_plain_order_to_the_bit(nb, D, F, nf, f0, sms,
                                                     layout):
    """The mirror of the kernel's tiles, stages and per-thread sums at
    the selector's tile and chunk gives each output the plain loop's
    bits, and the plain version's values."""
    rng = np.random.RandomState(nb + D)
    vf = _cplx(rng, (nb, D, F))
    G = _cplx(rng, (nb, D, nf))
    tile, chunk = fourier.bwd_tile(nb, D, nf, torch.complex128, sms=sms)
    assert (tile, chunk) == layout
    H = staged_mirror(G, vf, f0, tile, chunk)
    assert torch.equal(H, plain_loop(G, vf, f0))
    want = fourier.fourier_contract_bwd_plain(G, vf, f0)
    scale = float(want.abs().max())
    assert float((H - want).abs().max()) <= RTOL * scale


def _slfm_pair(D, R, m, seed):
    """A JAX and a port 'slfm' fft GroupState on a 1-D grid of m points
    from the same seeded A, symbol and diagonal (an interpolant that
    states only its column count)."""
    rng = np.random.RandomState(seed)
    F = tgrid.bttb.fourier_shape((m,))[0]
    A = rng.standard_normal((D, R))
    T_ = rng.standard_normal((R, F)) + 1j * rng.standard_normal((R, F))
    K_ = rng.standard_normal((D, F)) + 1j * rng.standard_normal((D, F))
    cols = types.SimpleNamespace(ncols=D * m)
    gj = jgrid.GroupState(sizes=(m,), rep="slfm", mode="fft", interp=cols,
                          A=jnp.asarray(A), That_rep=jnp.asarray(T_),
                          diag_That=jnp.asarray(K_))
    gt = tgrid.GroupState(interp=cols, sizes=(m,), rep="slfm", mode="fft",
                          A=torch.as_tensor(A), That_rep=torch.as_tensor(T_),
                          diag_That=torch.as_tensor(K_))
    return gj, gt, (A, T_, K_)


@pytest.mark.parametrize("nb", [3, 17])
def test_slfm_gradient_with_the_mirror_matches_jax(nb, monkeypatch):
    """The gradient of <W, K_UU u> in the 'slfm' symbol (A, T, K)
    through the port's FourierContract, with the staged mirror as its
    backward, against jax.grad through the JAX package's grid_matvec
    (its einsums at grid.py:398-404); torch's complex gradient is the
    conjugate of JAX's."""
    D, R, m = 4, 2, 20
    gj, gt, (A, T_, K_) = _slfm_pair(D, R, m, seed=nb)
    rng = np.random.RandomState(nb + 100)
    u = rng.standard_normal((nb, D * m))
    W = rng.standard_normal((nb, D * m))

    def jloss(a, t, k):
        g = gj.replace(A=a, That_rep=t, diag_That=k)
        return jnp.sum(jnp.asarray(W) * g.grid_matvec(jnp.asarray(u)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(A), jnp.asarray(T_), jnp.asarray(K_))

    def mirror(G, vf, f0=0):
        nb_, D_, nf = G.shape
        return staged_mirror(G, vf, f0, *fourier.bwd_tile(
            nb_, D_, nf, G.dtype, sms=4))

    monkeypatch.setattr(fourier, "fourier_contract_bwd", mirror)
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (A, T_, K_)]
    g = dataclasses.replace(gt, A=leaves[0], That_rep=leaves[1],
                            diag_That=leaves[2])
    loss = (torch.as_tensor(W) * g.grid_matvec(torch.as_tensor(u))).sum()
    got = torch.autograd.grad(loss, leaves)
    for a, b in zip(got, want):
        b = np.asarray(b)
        a = a.numpy()
        if np.iscomplexobj(b):
            a = np.conj(a)
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()))
