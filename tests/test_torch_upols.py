"""ops/upols of the PyTorch port against the JAX package: the single-block
step (with the JAX MAC lowered as `dot` and as the Pallas kernel in
interpret mode) and the float64 oracle through a partition wrap; the paged
step's analysis, MAC and synthesis; the carried states compared directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airwave_tpu.oracle.upols_oracle import UPOLSOracle
from airwave_tpu.ops import upols as jupols
from airwave_tpu_torch.ops import upols as tupols

PORT_TOL = 1e-6    # port vs JAX, both fp32
ORACLE_TOL = 1e-5  # vs the float64 oracle (BASELINE.md contract)


def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    # Pages not yet written are zero on both sides: their error is 0.
    return np.sqrt(np.mean((a - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)),
                                                  1e-30)


def _jax_steps(impl, params, B, S, T, xs):
    original = jupols._MAC_IMPL
    try:
        jupols._MAC_IMPL = impl
        step = jax.jit(jupols.conv_step)
        state = jupols.make_conv_state(B, S, params.partition_count, T)
        ys = []
        for x in xs:
            state, y = step(params, state, jnp.asarray(x))
            ys.append(np.asarray(y))
    finally:
        jupols._MAC_IMPL = original
    return state, np.concatenate(ys, -1)


def test_conv_step_through_partition_wrap_matches_jax_and_oracle():
    rng = np.random.default_rng(7)
    T, L, B, S, E = 64, 300, 3, 2, 2
    hrir = (rng.standard_normal((S, E, L)) * 0.3).astype(np.float32)
    n_blocks = 20  # > P2 = 9: the circular delay line wraps
    xs = [(rng.standard_normal((B, S, T))).astype(np.float32)
          for _ in range(n_blocks)]

    pt = tupols.make_conv_params(hrir, T, device="cpu")
    assert pt.partition_count == 9
    Kp = tupols.padded_bin_count(T)
    bank, synth = tupols.single_block_bank(pt, Kp), tupols.project_weights(pt, Kp)
    st = tupols.make_conv_state(B, S, pt.partition_count, T, device="cpu")
    ys = []
    for x in xs:
        st, y = tupols.conv_step(pt, st, torch.from_numpy(x), bank, synth)
        ys.append(y.numpy())
    got = np.concatenate(ys, -1)

    pj = jupols.make_conv_params(hrir, T)
    for impl in ("dot", "pallas"):
        sj, ref = _jax_steps(impl, pj, B, S, T, xs)
        assert rel_rms(got, ref) <= PORT_TOL, impl
        assert st.write_pos == int(sj.write_pos) == n_blocks % 9
        assert rel_rms(st.fdl.numpy(), np.asarray(sj.fdl)) <= PORT_TOL

    x = np.stack(xs, -2).reshape(B, S, n_blocks * T)
    for b in range(B):
        for e in range(E):
            ref = sum(_oracle(hrir[s, e], x[b, s], T) for s in range(S))
            assert rel_rms(got[b, e], ref) <= ORACLE_TOL, (b, e)


def _oracle(h, signal, T):
    o = UPOLSOracle(h, T)
    return np.concatenate([o.process(signal[i:i + T])
                           for i in range(0, signal.size, T)])


def test_conv_step_builds_operands_when_not_given():
    rng = np.random.default_rng(8)
    hrir = (rng.standard_normal((2, 2, 150)) * 0.3).astype(np.float32)
    p = tupols.make_conv_params(hrir, 64, device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, 2, 64)).astype(np.float32))
    s1 = tupols.make_conv_state(2, 2, p.partition_count, 64, device="cpu")
    s2 = tupols.make_conv_state(2, 2, p.partition_count, 64, device="cpu")
    Kp = tupols.padded_bin_count(64)
    for _ in range(3):
        s1, y1 = tupols.conv_step(p, s1, x)
        s2, y2 = tupols.conv_step(p, s2, x, tupols.single_block_bank(p, Kp),
                                  tupols.project_weights(p, Kp))
        torch.testing.assert_close(y1, y2, rtol=0, atol=0)


@pytest.mark.parametrize("M,L", [(4, 5 * 64 + 13), (2, 3)])
def test_conv_step_paged_matches_jax(M, L):
    rng = np.random.default_rng(M)
    B, S, T = 3, 2, 64
    hrir = (rng.standard_normal((S, 2, L)) * 0.3).astype(np.float32)
    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    n_pages = pj.partition_count // M
    sj = jupols.make_conv_state_paged(B, S, pj.partition_count, T, M)
    st = tupols.make_conv_state_paged(B, S, pt.partition_count, T, M, device="cpu")
    assert len(st.pages) == n_pages
    Kp = tupols.padded_bin_count(T)
    bank = tupols.paged_bank(pt, M, Kp)
    raw = jax.jit(jupols.conv_step_paged_raw)
    for _ in range(2 * n_pages + 3):  # the page rotation wraps twice
        x = (rng.standard_normal((B, S, M, T)) * 0.5).astype(np.float32)
        sj, ykm_j = raw(pj, sj, jnp.asarray(x))
        yj = np.asarray(jupols.paged_project(pj, ykm_j))
        st, ykm_t = tupols.conv_step_paged_raw(pt, st, torch.from_numpy(x), bank)
        yt = tupols.paged_project(pt, ykm_t).numpy()
        ykm_ref = np.asarray(ykm_j).reshape(Kp, B, M, 2, 2).transpose(2, 3, 4, 0, 1)
        assert rel_rms(ykm_t.numpy(), ykm_ref) <= PORT_TOL
        assert rel_rms(yt, yj) <= PORT_TOL
        for a, b in zip(st.pages, sj.pages):
            assert a.shape == b.shape
            assert rel_rms(a.numpy(), np.asarray(b)) <= PORT_TOL
    # The composed step equals raw + project.
    x = torch.from_numpy((rng.standard_normal((B, S, M, T))).astype(np.float32))
    s_a, y_a = tupols.conv_step_paged(pt, st, x)
    s_b, ykm = tupols.conv_step_paged_raw(pt, st, x, bank)
    torch.testing.assert_close(y_a, tupols.paged_project(pt, ykm))


def test_paged_project_with_post_matches_jax():
    rng = np.random.default_rng(3)
    B, S, T, M = 2, 2, 64, 2
    hrir = (rng.standard_normal((S, 2, 100)) * 0.3).astype(np.float32)
    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    Kp = tupols.padded_bin_count(T)
    ykm = rng.standard_normal((M, 2, 2, Kp, B)).astype(np.float32)
    post = rng.standard_normal((T, 80)).astype(np.float32)
    ykm_j = ykm.transpose(3, 4, 0, 1, 2).reshape(Kp, B, 1, M, 2, 2)
    yj = np.asarray(jupols.paged_project(pj, jnp.asarray(ykm_j), jnp.asarray(post)))
    yt = tupols.paged_project(pt, torch.from_numpy(ykm), torch.from_numpy(post))
    assert yt.shape == (B, M, 2, 80)
    assert rel_rms(yt.numpy(), yj) <= PORT_TOL


def test_conv_resets_match_jax():
    rng = np.random.default_rng(9)
    fdl = rng.standard_normal((72, 2, 3, 2, 4)).astype(np.float32)
    mask = np.array([True, False, True, False])
    sj = jupols.conv_reset(jupols.ConvState(jnp.asarray(fdl), jnp.int32(2)),
                           jnp.asarray(mask))
    st = tupols.conv_reset(tupols.ConvState(torch.tensor(fdl), 2),
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(st.fdl.numpy(), np.asarray(sj.fdl))
    assert st.write_pos == 2
    st = tupols.conv_reset(st)
    assert st.write_pos == 0 and not st.fdl.any()

    pages = [rng.standard_normal((72, 2, 2, 4, 4)).astype(np.float32)
             for _ in range(2)]
    pj = jupols.conv_reset_paged(
        jupols.PagedConvState(tuple(map(jnp.asarray, pages))), jnp.asarray(mask))
    pt = tupols.conv_reset_paged(
        tupols.PagedConvState(tuple(map(torch.tensor, pages))),
        torch.from_numpy(mask))
    for a, b in zip(pt.pages, pj.pages):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not any(pg.any() for pg in tupols.conv_reset_paged(pt).pages)


def test_masked_conv_resets_write_in_place():
    """A masked reset (a pool's attach) zeroes the lanes in the delay line
    it is given: no second copy of the carry, whose transient doubled a
    capacity pool's peak on the card."""
    rng = np.random.default_rng(10)
    mask = torch.tensor([False, True, False, True])
    fdl = torch.tensor(rng.standard_normal((72, 2, 3, 2, 4)), dtype=torch.float32)
    want = fdl.clone()
    want[..., 1::2] = 0
    st = tupols.conv_reset(tupols.ConvState(fdl, 1), mask)
    assert st.fdl.data_ptr() == fdl.data_ptr() and st.write_pos == 1
    assert torch.equal(fdl, want)
    pages = tuple(torch.tensor(rng.standard_normal((72, 2, 2, 4, 4)),
                               dtype=torch.float32) for _ in range(2))
    pt = tupols.conv_reset_paged(tupols.PagedConvState(pages), mask)
    for got, page in zip(pt.pages, pages):
        assert got.data_ptr() == page.data_ptr()
        assert not page[..., 1::2].any() and page[..., 0::2].all()


def test_full_conv_resets_write_in_place_and_match_jax():
    """Without a mask the reset zeroes the delay line it is given (each
    leaf keeps its storage: a pool at its plan has no room for a second
    carry) and equals the JAX package's functional reset, write_pos 0."""
    rng = np.random.default_rng(11)
    fdl = rng.standard_normal((72, 2, 3, 2, 4)).astype(np.float32)
    sj = jupols.conv_reset(jupols.ConvState(jnp.asarray(fdl), jnp.int32(2)))
    line = torch.tensor(fdl)
    st = tupols.conv_reset(tupols.ConvState(line, 2))
    assert st.fdl.data_ptr() == line.data_ptr()
    np.testing.assert_array_equal(line.numpy(), np.asarray(sj.fdl))
    assert st.write_pos == int(sj.write_pos) == 0
    pages = [rng.standard_normal((72, 2, 2, 4, 4)).astype(np.float32)
             for _ in range(3)]
    pj = jupols.conv_reset_paged(
        jupols.PagedConvState(tuple(map(jnp.asarray, pages))))
    leaves = tuple(map(torch.tensor, pages))
    pt = tupols.conv_reset_paged(tupols.PagedConvState(leaves))
    for got, leaf, want in zip(pt.pages, leaves, pj.pages):
        assert got.data_ptr() == leaf.data_ptr()
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))


def test_full_conv_reset_of_an_inference_carry():
    """A carry made under inference_mode (as the pool and the engine make
    theirs) is reset in place outside it too."""
    with torch.inference_mode():
        st = tupols.make_conv_state(4, 2, 3, 64, device="cpu")
        pt = tupols.make_conv_state_paged(4, 2, 4, 64, 2, device="cpu")
        st.fdl.fill_(1.0)
        for pg in pt.pages:
            pg.fill_(1.0)
    assert not tupols.conv_reset(st).fdl.any()
    assert not any(pg.any() for pg in tupols.conv_reset_paged(pt).pages)


def test_state_builders_match_jax():
    st = tupols.make_conv_state(3, 2, 9, 64, device="cpu")
    sj = jupols.make_conv_state(3, 2, 9, 64)
    assert st.fdl.shape == sj.fdl.shape and st.write_pos == 0
    pt = tupols.make_conv_state_paged(3, 2, 12, 64, 4, device="cpu")
    pj = jupols.make_conv_state_paged(3, 2, 12, 64, 4)
    assert [p.shape for p in pt.pages] == [p.shape for p in pj.pages]
    with pytest.raises(ValueError):
        tupols.make_conv_state_paged(3, 2, 10, 64, 4, device="cpu")


def _pause_pattern(rng, B, step, lap):
    """Lanes active at `step`: random, all in the first two steps, and lane
    0 held idle for more than a full lap once."""
    active = rng.random(B) < 0.55
    if step < 2:
        active[:] = True
    if lap + 2 <= step <= 2 * lap + 4:
        active[0] = False
    return active


def test_masked_ring_step_with_debt_rolls_matches_jax():
    """The pool's shared-cursor ring at the op level: the masked slot write
    preserves idle lanes, conv_roll_lanes re-aligns them at rejoin (also
    after a pause longer than a cursor lap). The carry and the active
    lanes' output match the JAX ops step for step."""
    rng = np.random.default_rng(3)
    T, B, S = 64, 5, 2
    hrir = (rng.standard_normal((S, 2, 400)) * 0.3).astype(np.float32)
    pj = jupols.make_conv_params(hrir, T)
    pt = tupols.make_conv_params(hrir, T, device="cpu")
    p2 = pt.partition_count
    sj = jupols.make_conv_state(B, S, p2, T)
    st = tupols.make_conv_state(B, S, p2, T, device="cpu")
    debt = np.zeros(B, np.int64)
    rolled = 0
    for step in range(3 * p2 + 8):
        active = _pause_pattern(rng, B, step, p2)
        x = (rng.standard_normal((B, S, T)) * active[:, None, None]
             ).astype(np.float32)
        rejoin = np.where(active & (debt % p2 != 0))[0]
        if len(rejoin):
            sj = jupols.conv_roll_lanes(sj, jnp.asarray(rejoin, np.int32),
                                        jnp.asarray(debt[rejoin], np.int32))
            fdl = st.fdl
            st = tupols.conv_roll_lanes(st, torch.from_numpy(rejoin),
                                        torch.from_numpy(debt[rejoin]))
            assert st.fdl is fdl  # in place: the kernel's operand stays put
            rolled += 1
        sj, yj = jupols.conv_step(pj, sj, jnp.asarray(x), jnp.asarray(active))
        st, yt = tupols.conv_step(pt, st, torch.from_numpy(x),
                                  active_mask=torch.from_numpy(active))
        assert st.fdl.is_contiguous() and st.write_pos == int(sj.write_pos)
        assert rel_rms(st.fdl.numpy(), np.asarray(sj.fdl)) <= PORT_TOL, step
        if active.any():
            assert rel_rms(yt.numpy()[active],
                           np.asarray(yj)[active]) <= PORT_TOL, step
        debt[active] = 0
        debt[~active] += 1
    assert rolled > 0


def test_masked_paged_step_with_debt_rolls_matches_jax():
    """The pool's paged tier at the op level: idle lanes recycle their
    oldest page, conv_roll_lanes_paged re-aligns them at rejoin (also after
    a pause longer than a page cycle); pages and active output match JAX."""
    rng = np.random.default_rng(4)
    T, B, S, M = 64, 5, 2, 4
    hrir = (rng.standard_normal((S, 2, 400)) * 0.3).astype(np.float32)
    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, lookahead=M,
                                 device="cpu")
    p2 = pt.partition_count
    n_pages = p2 // M
    sj = jupols.make_conv_state_paged(B, S, p2, T, M)
    st = tupols.make_conv_state_paged(B, S, p2, T, M, device="cpu")
    debt = np.zeros(B, np.int64)
    rolled = 0
    for rnd in range(4 * n_pages + 6):
        active = _pause_pattern(rng, B, rnd, n_pages)
        x = (rng.standard_normal((B, S, M, T)) * active[:, None, None, None]
             ).astype(np.float32)
        rejoin = np.where(active & (debt % n_pages != 0))[0]
        if len(rejoin):
            sj = jupols.conv_roll_lanes_paged(
                sj, jnp.asarray(rejoin, np.int32),
                jnp.asarray(debt[rejoin], np.int32))
            st = tupols.conv_roll_lanes_paged(
                st, torch.from_numpy(rejoin), torch.from_numpy(debt[rejoin]))
            rolled += 1
        sj, yj = jupols.conv_step_paged(pj, sj, jnp.asarray(x),
                                        active_mask=jnp.asarray(active))
        st, yt = tupols.conv_step_paged(pt, st, torch.from_numpy(x),
                                        active_mask=torch.from_numpy(active))
        for a, b in zip(st.pages, sj.pages):
            assert rel_rms(a.numpy(), np.asarray(b)) <= PORT_TOL, rnd
        if active.any():
            assert rel_rms(yt.numpy()[active],
                           np.asarray(yj)[active]) <= PORT_TOL, rnd
        debt[active] = 0
        debt[~active] += 1
    assert rolled > 0


def test_pad_conv_params_matches_jax():
    rng = np.random.default_rng(6)
    hrir = (rng.standard_normal((2, 2, 150)) * 0.3).astype(np.float32)
    pj = jupols.make_conv_params(hrir, 64, pad_to_pow2=False)
    pt = tupols.make_conv_params(hrir, 64, pad_to_pow2=False, device="cpu")
    assert tupols.pad_conv_params(pt, pt.partition_count) is pt
    for a, b in zip(tupols.pad_conv_params(pt, 7),
                    jupols.pad_conv_params(pj, 7)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="cannot shrink"):
        tupols.pad_conv_params(pt, 2)


@pytest.mark.parametrize("S", [1, 3])
def test_rotated_operand_is_contiguous(S):
    """The single-block MAC operand at every cursor is contiguous, as the
    card's kernel requires, for one speaker too (where the reshape of the
    rotated slice would be a strided view), and equals the rotated bank."""
    rng = np.random.default_rng(S)
    hrir = (rng.standard_normal((S, 2, 300)) * 0.2).astype(np.float32)
    params = tupols.make_conv_params(hrir, 64, device="cpu")
    bank = tupols.single_block_bank(params, 72)
    P2 = params.partition_count
    for w in range(P2):
        h = tupols._rotated_operand(bank, w)
        assert h.is_contiguous()
        want = bank[:, :, :, P2 - 1 - w:2 * P2 - 1 - w].reshape(h.shape)
        torch.testing.assert_close(h, want, rtol=0, atol=0)


def test_conv_step_reads_the_rotated_window_in_place(monkeypatch):
    """conv_step hands the MAC the rotated window of the doubled bank as it
    lies (a [Kp, O, S, P2, C] view sharing the bank's storage, no copy) at
    every cursor; through a partition wrap (S=2, an odd P2 = 5, pad_to_pow2
    off) its output and carry stay within 1e-6 of the JAX conv_step (the
    MAC lowered as `dot` and as the Pallas kernel in interpret mode) on the
    same seeded inputs."""
    rng = np.random.default_rng(12)
    T, L, B, S = 64, 200, 3, 2
    hrir = (rng.standard_normal((S, 2, L)) * 0.3).astype(np.float32)
    pt = tupols.make_conv_params(hrir, T, pad_to_pow2=False, device="cpu")
    P2 = pt.partition_count
    assert P2 == 5
    Kp = tupols.padded_bin_count(T)
    bank, synth = tupols.single_block_bank(pt, Kp), tupols.project_weights(pt, Kp)
    seen = []
    mac = tupols.mac_kmajor

    def recording(fdl, h, out=None, **kw):
        seen.append((tuple(h.shape), h.data_ptr(), h.untyped_storage().data_ptr()))
        return mac(fdl, h, out=out, **kw)

    monkeypatch.setattr(tupols, "mac_kmajor", recording)
    n_blocks = 3 * P2 + 2
    xs = [rng.standard_normal((B, S, T)).astype(np.float32)
          for _ in range(n_blocks)]
    st = tupols.make_conv_state(B, S, P2, T, device="cpu")
    ys = []
    for x in xs:
        st, y = tupols.conv_step(pt, st, torch.from_numpy(x), bank, synth)
        ys.append(y.numpy())
    got = np.concatenate(ys, -1)
    row = bank.stride(3) * 4  # bytes a partition slot of the bank
    assert [shape for shape, _, _ in seen] == [(Kp, 4, S, P2, 2)] * n_blocks
    assert all(storage == bank.untyped_storage().data_ptr()
               for _, _, storage in seen)
    assert [(ptr - bank.data_ptr()) // row for _, ptr, _ in seen] == [
        P2 - 1 - t % P2 for t in range(n_blocks)]

    pj = jupols.make_conv_params(hrir, T, pad_to_pow2=False)
    for impl in ("dot", "pallas"):
        sj, ref = _jax_steps(impl, pj, B, S, T, xs)
        assert rel_rms(got, ref) <= PORT_TOL, impl
        assert st.write_pos == int(sj.write_pos) == n_blocks % P2
        assert rel_rms(st.fdl.numpy(), np.asarray(sj.fdl)) <= PORT_TOL
