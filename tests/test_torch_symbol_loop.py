"""A CPU rehearsal of the kernels' symbol-major loop order.

csrc/psk_common.cuh's symbol_loop walks each channel symbol by symbol:
the run up to the next symbol (its length n from sp iterated down, its
phases from the chain of wrap(ph + fr)), the run's mixes spread over G
lanes of K mixes each, written into a ring (the smallest power of two at
least W and at least G * K samples), then the symbol step on the window
read from the ring; a pass ends at a symbol, at G * K samples or at T.
(G, K) and the ring come from the kernels' rule for the window length W
(``nvcc.lane_layout``, held to psk_common.cuh's ``with_lanes``). ``symbol_major`` below is a scalar Python model of that
control flow for one channel at a time, built from the plain loops' own
arithmetic (dsp/psk.py's _Loop), so it must equal ``scan_packed`` bit for
bit: output bytes and every state leaf. The cases are the ones the new
order creates: channels whose symbol rates are spread over +/-2% (lanes
drift apart), T = 1, a T that no run length divides, a state with a symbol
due at t = 0, two calls with carried state, and (G, K) layouts whose pass
is shorter than a run, so that a run takes several passes; at the live
widths (W = 10, 11, 16) and at W = 13, 20, 21, 32, 40 and 80 (captures at
32 to 192 kHz, and 25 kHz channels).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdrtrunk_tpu_torch.dsp.interpolator import CENTER, NSTEPS, NTAPS
from sdrtrunk_tpu_torch.dsp.nvcc import (MAX_WINDOW, MIN_WINDOW, lane_layout,
                                         ring_size)
from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator, DQPSKState,
                                        GardnerDQPSKDemodulator, GardnerState,
                                        _Loop)
from sdrtrunk_tpu_torch.signal.generators import (awgn, c4fm_modulate,
                                                  lsm_modulate, random_dibits)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "sdrtrunk_tpu_torch" / "csrc"
# (kind, sample rate, baud, gain): the live widths, then the wider ones
# (W in the name) of captures and 25 kHz channels (50 kHz) at other rates
LOOPS = {"dqpsk": ("dqpsk", 25000.0, 4800.0, 0.3),
         "lsm": ("gardner", 25000.0, 4800.0, 0.3),
         "p25p2": ("gardner", 50000.0, 6000.0, 0.1),
         "dqpsk_w13": ("dqpsk", 32000.0, 4800.0, 0.3),
         "lsm_w13": ("gardner", 32000.0, 4800.0, 0.3),
         "dqpsk_w20": ("dqpsk", 48000.0, 4800.0, 0.3),
         "lsm_w20": ("gardner", 50000.0, 4800.0, 0.3),
         "dmr_w21": ("dqpsk", 51200.0, 4800.0, 0.4),
         "p25p2_w21": ("gardner", 64000.0, 6000.0, 0.1),
         "dqpsk_w32": ("dqpsk", 76800.0, 4800.0, 0.3),
         "p25p2_w32": ("gardner", 96000.0, 6000.0, 0.1),
         "dqpsk_w40": ("dqpsk", 96000.0, 4800.0, 0.3),
         "lsm_w40": ("gardner", 96000.0, 4800.0, 0.3),
         "dqpsk_w80": ("dqpsk", 192000.0, 4800.0, 0.3),
         "lsm_w80": ("gardner", 192000.0, 4800.0, 0.3)}


def _demod(name):
    kind, rate, baud, gain = LOOPS[name]
    cls = DQPSKDemodulator if kind == "dqpsk" else GardnerDQPSKDemodulator
    return cls(rate, baud, gain, device="cpu")


def _t(demod, symbols: int) -> int:
    """A block length that holds about `symbols` symbols and that no run
    length divides (odd, and not a multiple of the samples a symbol)."""
    return int(symbols * demod.samples_per_symbol) | 1


def _block(name, c: int, t: int, seed: int, spread: float = 0.0):
    """(c, t) complex64 at 30 dB; channel i's symbol rate is baud times
    1 + spread * (2 i / (c - 1) - 1)."""
    kind, rate, baud, _ = LOOPS[name]
    rows = []
    for i in range(c):
        b = baud * (1.0 + spread * (2.0 * i / max(c - 1, 1) - 1.0))
        dib = random_dibits(int(t * b / rate) + 16, seed=seed + i)
        x = (c4fm_modulate(dib, rate, b) if kind == "dqpsk"
             else lsm_modulate(dib, sample_rate=rate, symbol_rate=b))
        rows.append(awgn(x[:t], snr_db=30.0,
                         rng=np.random.default_rng(seed + 100 + i)))
    return torch.as_tensor(np.stack(rows).astype(np.complex64))


def _state(demod, c: int):
    cls = DQPSKState if isinstance(demod, DQPSKDemodulator) else GardnerState
    return cls(*[a.expand((c,) + a.shape).clone() for a in demod.init_state()])


def _dqpsk_step(lp, demod, win, sp1, phase, tm, prev):
    """dqpsk.cu's DqpskStep for one channel, in scan_packed's ops."""
    mu = torch.clamp(sp1, 0.0, 1.0)
    idx = (mu * float(NSTEPS)).long().clamp_(0, NSTEPS)
    cur = lp.interp(demod.bank.double()[idx],
                    torch.stack(win[:NTAPS], 1).double())
    pts = torch.stack([win[CENTER], cur], 1)
    zn = lp.diff_norm(pts, prev)
    pqn, cin, cqn = zn[:, 0, 1], zn[:, 1, 0], zn[:, 1, 1]
    i_pos, byte, err = lp.decide(cin, cqn)
    polarity = torch.where(torch.where(i_pos, pqn > cqn, pqn < cqn),
                           lp.one, lp.mone)
    tm[:] = lp.update(err * polarity, err, sp1, tm[1], tm[3], phase)
    return byte, (pts,)


def _gardner_step(lp, demod, win, sp1, phase, tm, prev, prev_sym):
    """gardner.cu's GardnerStep for one channel, in scan_packed's ops."""
    w = demod.window_len
    mid_lo, mid_hi, cur_lo, cur_hi = demod.base_ranges()
    off = torch.stack([torch.clamp(sp1, 0.0, 1.0), tm[1] * 0.5], 1)
    k = torch.floor(off)
    arm = ((off - k) * float(NSTEPS)).long().clamp_(0, NSTEPS)
    base = k.long().clamp_(0, w - 8)
    fetch = (base[..., None] + torch.arange(NTAPS)).reshape(1, 2 * NTAPS, 1)
    w8 = torch.stack(win, 1).double().gather(
        1, fetch.expand(1, 2 * NTAPS, 2)).reshape(1, 2, NTAPS, 2)
    inset = ((base >= torch.tensor([mid_lo, cur_lo]))
             & (base <= torch.tensor([mid_hi, cur_hi])))[..., None]
    pts = torch.where(inset, lp.interp(demod.bank.double()[arm], w8), lp.zero)
    zn = lp.diff_norm(pts, prev)
    ms, cs = zn[:, 0], zn[:, 1]
    d64 = (prev_sym - cs).double()
    m64 = ms.double()
    terr = (d64[:, 0] * m64[:, 0]
            + (d64[:, 1] * m64[:, 1]).float().double()).float()
    terr = torch.clamp(torch.nan_to_num(terr, nan=0.0), -0.3, 0.3)
    _, byte, err = lp.decide(cs[:, 0], cs[:, 1])
    tm[:] = lp.update(terr, err, sp1, tm[1], tm[3], phase)
    return byte, (pts, cs)


def symbol_major(demod, x: torch.Tensor, state, g: int, k: int):
    """Scalar model of symbol_loop with G = g lanes of k mixes and the
    kernels' ring for (W, g * k): (T, C) uint8 packed bytes and the new
    state, channel by channel."""
    gardner = isinstance(demod, GardnerDQPSKDemodulator)
    c_all, t_all = x.shape
    w = demod.window_len
    RING = ring_size(w, g * k)
    out = torch.zeros((t_all, c_all), dtype=torch.uint8)
    leaves = [[] for _ in state]
    for c in range(c_all):
        lp = _Loop(demod, x[c:c + 1])
        ring = [None] * RING
        for j in range(w):                              # load_ring
            ring[j % RING] = torch.view_as_real(state.window[c:c + 1, j])
        head = w
        tm = [leaf[c:c + 1] for leaf in state[1:5]]     # sp, dsps, ph, fr
        if gardner:
            prev = (torch.stack([torch.view_as_real(state.prev_mid_sample),
                                 torch.view_as_real(state.prev_cur_sample)],
                                1)[c:c + 1],
                    torch.view_as_real(state.prev_cur_symbol)[c:c + 1])
        else:
            prev = (torch.stack([torch.view_as_real(state.prev_preceding),
                                 torch.view_as_real(state.prev_current)],
                                1)[c:c + 1],)
        t = 0
        while t < t_all:
            # --- the run: its length and phases ---
            sp, ph = tm[0], tm[2]
            phs, n, due = {}, 0, False
            for i in range(g * k):
                if due or t + i >= t_all:
                    break
                phase = lp.wrap(ph + tm[3])
                sp1 = sp - 1.0
                phs[(i % g, i // g)] = phase            # lane, slot
                n = i + 1
                due = bool(sp1 < 1.0)
                if not due:
                    sp, ph = sp1, phase
            # --- its mixes, lane by lane ---
            for lane in range(g):
                for kk in range(k):
                    i = lane + g * kk
                    if i < n:
                        ring[(head + i) % RING] = lp.mix(t + i, phs[(lane, kk)])
            head += n
            t += n
            if due:
                win = [ring[(head - w + j) % RING] for j in range(w)]
                step = _gardner_step if gardner else _dqpsk_step
                byte, prev = step(lp, demod, win, sp1, phase, tm, *prev)
                out[t - 1, c] = byte[0]
            else:
                tm[0], tm[2] = sp, ph
        window = torch.view_as_complex(torch.stack(
            [ring[(head - w + j) % RING] for j in range(w)], 1))
        tail = ([prev[0][:, 0], prev[0][:, 1], prev[1]] if gardner
                else [prev[0][:, 0], prev[0][:, 1]])
        for leaf, v in zip(leaves, [window, *tm, *[
                torch.view_as_complex(p.contiguous()) for p in tail]]):
            leaf.append(v)
    return out, type(state)(*[torch.cat(v) for v in leaves])


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    for name, a, b in zip(type(want[1])._fields, got[1], want[1]):
        assert torch.equal(a, b), name


def test_layout_rule_matches_the_kernels():
    """nvcc.lane_layout is psk_common.cuh's with_lanes (the W bounds of
    each (G, K) branch, read from the source) and kMinWindow /
    kMaxWindow; the live widths keep their layouts (8 lanes at W = 10 and
    11, 16 at W = 16) and the ring of 16 samples."""
    header = (CSRC / "psk_common.cuh").read_text()
    body = header[header.index("int with_lanes("):]
    body = body[:body.index("\n}\n")]
    rows = [(int(w) if w else MAX_WINDOW, int(g), int(k)) for w, g, k in
            re.findall(r"(?:W <= (\d+)\) \{|else \{)\s*launch\(Lanes<(\d+), "
                       r"(\d+)>", body)]
    assert len(rows) == 4
    assert f"kMinWindow = {MIN_WINDOW};" in header
    assert f"kMaxWindow = {MAX_WINDOW};" in header
    for w in range(MIN_WINDOW, MAX_WINDOW + 1):
        g, k = next((g, k) for top, g, k in rows if w <= top)
        assert lane_layout(w) == (g, k, ring_size(w, g * k)), w
    assert [lane_layout(w) for w in (10, 11, 16)] == [(8, 1, 16)] * 2 + [
        (16, 1, 16)]
    assert [_demod(n).window_len for n in LOOPS] == [
        10, 11, 16, 13, 13, 20, 20, 21, 21, 32, 32, 40, 40, 80, 80]


@pytest.mark.parametrize("name", list(LOOPS))
def test_kernel_layout_equals_plain_loop_with_drift(name):
    """The kernel's (G, K) and ring, channels spread over +/-2% of the
    symbol rate, and a T that no run length divides (301 at the live
    widths, about 40 symbols above)."""
    demod = _demod(name)
    t = max(301, _t(demod, 40))
    x = _block(name, 4, t, 3, spread=0.02)
    s0 = _state(demod, 4)
    want = demod.scan_packed(x, s0)
    assert int((want[0] >= 4).sum()) > 4 * 301 / 10      # symbols flowed
    g, k, _ = lane_layout(demod.window_len)
    _assert_equal(symbol_major(demod, x, s0, g, k), want)


@pytest.mark.parametrize("gk", [(1, 10), (4, 1), (2, 3)],
                         ids=["one-lane", "short-pass", "two-lanes"])
@pytest.mark.parametrize("name", ["dqpsk", "p25p2", "dqpsk_w40"])
def test_other_layouts_equal_plain_loop(name, gk):
    """One lane mixing a run, and passes shorter than a run (a run spans
    several passes; at W = 40, every layout here)."""
    demod = _demod(name)
    x = _block(name, 2, max(157, _t(demod, 8)), 11)
    s0 = _state(demod, 2)
    _assert_equal(symbol_major(demod, x, s0, *gk), demod.scan_packed(x, s0))


@pytest.mark.parametrize("name", list(LOOPS))
def test_edges_t1_due_at_zero_and_carried_state(name):
    """T = 1; a channel with a symbol due at t = 0 (sp < 2); two calls
    with carried state equal one."""
    demod = _demod(name)
    gk = lane_layout(demod.window_len)[:2]
    t = max(120, _t(demod, 12))
    split = t * 2 // 5
    x = _block(name, 3, t, 5)
    s0 = _state(demod, 3)
    s0.sampling_point[1] = 1.5
    for n in (1, t):
        xs = x[:, :n]
        _assert_equal(symbol_major(demod, xs, s0, *gk),
                      demod.scan_packed(xs, s0))
    out1, s1 = symbol_major(demod, x[:, :split], s0, *gk)
    out2, s2 = symbol_major(demod, x[:, split:], s1, *gk)
    want = demod.scan_packed(x, s0)
    _assert_equal((torch.cat([out1, out2]), s2), want)
    assert want[0][0, 1] >= 4                            # due at t = 0


@pytest.mark.parametrize("kind", ["dqpsk", "gardner", "bit_timing"])
def test_wrappers_refuse_a_window_above_their_kernel(kind):
    """Each kernel's wrapper raises ValueError for a window length above
    its kernel's, before it builds or launches anything (here, with no
    nvcc and no card, a build or a launch would raise something else):
    W = 130 for the symbol loops (above 128, at 312 kHz and 4800 Bd),
    W = 513 for bit timing (above its eight-word delay line: LTR at 77 kHz
    audio)."""
    from sdrtrunk_tpu_torch.dsp import bit_timing_cuda, dqpsk_cuda, gardner_cuda
    from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator

    if kind == "bit_timing":
        geom = LTRFSKDemodulator(sample_rate=77000.0, device="cpu").geometry
        assert geom.window_len == 513
        with pytest.raises(ValueError,
                           match="W = 513 .*above the kernel's 512"):
            bit_timing_cuda.bit_timing_cuda(
                geom, torch.zeros((2, 16)),
                torch.zeros((2, 513), dtype=torch.int8), torch.ones(2))
        return
    cls, wrapper = ((DQPSKDemodulator, dqpsk_cuda.dqpsk_cuda)
                    if kind == "dqpsk" else
                    (GardnerDQPSKDemodulator, gardner_cuda.gardner_cuda))
    demod = cls(312000.0, 4800.0, device="cpu")
    assert demod.window_len == 130
    with pytest.raises(ValueError, match=r"W = 130 \(312000.0 Hz, 4800.0 Bd\)"
                                         r".*\[8, 128\]"):
        wrapper(demod, torch.zeros((2, 16), dtype=torch.complex64),
                _state(demod, 2))


def test_split_tool_finds_its_markers():
    """tools/symbol_loop_split.py times and splits the kernels through
    copies it edits by text; every edit must still find its place in
    csrc/ as it stands."""
    spec = importlib.util.spec_from_file_location(
        "symbol_loop_split", ROOT / "tools" / "symbol_loop_split.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    header = (CSRC / "psk_common.cuh").read_text()
    sources = {n: (CSRC / f"{n}.cu").read_text() for n in ("dqpsk", "gardner")}
    assert tool.symbol_major(header)
    h, src = tool.instrument(header, sources, True, False, False)
    assert h.count("clock64()") == 4
    assert all("read_clk" in text for text in src.values())
    h, _ = tool.instrument(header, sources, False, True, False)
    assert "mix(xb[k], phs[k])" not in h
    h, _ = tool.instrument(header, sources, False, False, True)
    assert h.count("launch(Lanes<1, 7>{})") == 1
    assert h.count("launch(Lanes<1, 10>{})") == 1
