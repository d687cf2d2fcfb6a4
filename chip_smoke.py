#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sdrtrunk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [PHASE ...]

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). With no argument it runs every
phase below, which is the acceptance check; named phases (``edges``:
phase 3 and the bit-timing edge cases, ``bits`` and ``psk``: phase 4's
bit-timing and symbol-loop kernels, ``c4fm``, ``c4fm_25k``, ``p25p2``,
``lsm``, ``dmr``,
``nbfm``, ``am``, ``ltr``, ``mpt1327``, ``slots``, ``slots_p25p2``,
``multibank``, ``worker``: the live loops; ``cli``, ``monitor``,
``monitor_mixed``: the application; ``channelize``: the channelizer's
branch-sum kernel; ``parity``, ``receiver``: the
per-channel path and the static receiver; ``parallel``: the sharded
channelizer pipeline; ``bench``: the port's bench; ``reference``: the
five bench banks, five cells, five paths and the monitor against the JAX
package's digests) run those alone, after the environment and the
build, in this order; an unknown name raises. Each phase raises on
failure (the exit code is then not 0):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the six kernels, sdrtrunk_tpu_torch/csrc/dqpsk.cu, gardner.cu,
   bit_timing.cu, biquad.cu, cma.cu and channelize.cu, one nvcc each,
   started together, each library's build time; ptxas's registers and
   spills for each instantiation (a symbol loop's lane layout (G, K) and
   the window lengths it serves, the bit-timing line's 64-bit words L, the
   biquad's floats a sample V and copy path, the CMA's tree width P, the
   channelizer's one instantiation);
3. edge cases of the kernels' symbol-major loop, each kernel held bit for
   bit against its plain loop at every live window length and at W = 13,
   20, 21, 32, 40 and 80 (captures at 32 to 192 kHz; 25 kHz channels),
   both kernels at each: 37 channels (not a multiple of a warp), 32 of
   them at symbol rates spread over +/-2%, T = 997 (no run length divides
   it) and T = 1, a symbol due at t = 0, two calls with carried state;
4. each kernel against its plain PyTorch version on the card at the shape
   its live loop gives it, reached through ``batched``: identical on all
   1023 channels (dibits, valid, every state leaf), timed by CUDA events
   beside its bound (bytes over the memory rate or operations over the
   float64 rate), with the share of (sample, warp) pairs on which a warp
   of 32 channels has a symbol due: the DQPSK kernel at the C4FM bank's
   1023 channels x 10240 samples, at timing gain 0.3 (C4FM) and 0.4
   (DMR), at W = 16 (P25 Phase 2's decision-directed timing, 50 kHz,
   6000 Bd, gain 0.3, 1023 x 20480) and at W = 20 (C4FM on 25 kHz
   channels, 50 kHz, 4800 Bd, gain 0.3, 1023 x 10240), the Gardner kernel
   at W = 16 (P25
   Phase 2, 50 kHz, 1023 x 20480) and W = 11 (LSM, 25 kHz, 1023 x 10240);
   and the bit-timing kernel, reached through the demodulators' public
   call, against its
   plain loop (valid, bits, window, sampling point) at 1023 x 4000 with
   the LTR geometry on FSK audio, at 1023 x 3600 with the AFSK geometry
   on correlator output, at 1023 x 8000 with the LTR geometry on 16 kHz
   audio (W = 106, a line of two 64-bit words, 150 symbols a channel) and
   at 1023 x 12000 on 48 kHz audio (W = 320, five words, 75 symbols), and
   on its edge cases, also at W = 106 and W = 320:
   37 channels, T = 997 and T = 1, a symbol due at t = 0, two calls with
   carried state, an all-zero channel, and windows with exactly one
   crossing, exactly two, and two at equal distance from the ideal;
5. the live P25P1 C4FM loop at the product's full width: 12.8 MS/s of
   int8 IQ, 1024 bins, 1023 slots (a P25 control channel granting a
   traffic channel, one free slot for the grant, 1021 voice slots),
   through Orchestrator(decoder="c4fm", device="cuda").run() for 3
   warm-up and 4 timed chunks of 0.41 s. It must follow the grant, decode
   frames on >= 99% of the voice slots, produce audio and launch the DQPSK
   kernel once per chunk;
5a. ``c4fm_25k``: phase 5's bank on 25 kHz channels,
   Orchestrator(decoder="c4fm", channel_bandwidth=25000.0) at 12.8 MS/s:
   512 bins, a 50 kHz channel rate (the DQPSK loop at W = 20), 511 slots
   (a control channel whose IDEN_UP announces 25 kHz spacing granting a
   free slot, 509 voice slots), 2 + 3 chunks of 512 x 5120 (0.205 s);
   phase 5's checks and one DQPSK launch a chunk at W = 20;
6. the live P25 Phase 2 loop at the same width: 1023 slots of scrambled
   HDQPSK voice (PTT + VOICE_4 cycles ending in END_PTT) at random phases,
   the scramble parameters set on every slot as bench.py's P25P2 bank
   bench sets them, through Orchestrator(decoder="p25p2") for 3 + 4
   chunks. It must decode fragments on >= 99% of the voice slots, produce
   AudioSegments and launch the Gardner kernel once per chunk;
7. the live LSM bank at a smaller depth: 64 slots of P25 Phase 1 TSBK
   control streams, LSM-modulated, through Orchestrator(decoder="lsm") for
   3 chunks, with frames on >= 99% of the slots and one Gardner launch per
   chunk;
8. the live DMR loop at full width: 1023 slots, a TSCC control channel
   sending an aloha and Tier III group-voice grants (CSBK 0x31) for a
   channel of the band plan set with traffic.update_band, whose slot is
   left free for the grant, and 1021 voice slots carrying bench.py's DMR
   call cycle (voice header, 4 voice superframes with embedded LC,
   terminator) at random phases, through Orchestrator(decoder="dmr") for
   3 + 4 chunks. It must follow the grant, decode frames on >= 99% of the
   voice slots, produce AudioSegments and launch the DQPSK kernel (timing
   gain 0.4) once per chunk;
9. the live NBFM loop at full width: 1023 slots of NBFM voice (a 700 Hz
   tone at 0.7 from random starts), chunks of 1024 x 6400 samples (K =
   12800, a multiple of the resampler's 25), 2 + 4 chunks of mu-law PCM.
   Slots with an AudioSegment (open or completed) longer than 1 s must be
   >= 99%, the audio's dominant frequency on 16 sampled slots 700 +/- 50
   Hz, and no symbol kernel may launch;
10. the live AM loop at a smaller depth: 64 slots 16 bins apart, each a 1
   kHz tone at 50% AM depth, 3 chunks of 1024 x 6400; segments on >= 99%
   of the slots, each with its tone;
11. the live LTR loop at full width: 1023 slots, each an NBFM carrier with
   an 800 Hz voice tone plus sub-audible LTR CALL words of its own
   talkgroup (home, group) from a random start, chunks of 1024 x 6250
   samples (K = 12500, 4000 audio samples), 2 + 4 chunks, through
   Orchestrator(decoder="ltr"). CALL words with the slot's home and group
   on >= 99% of the slots, an AudioSegment longer than 1 s on every slot,
   and one bit-timing launch per chunk;
12. the live MPT1327 loop at the same width and chunks with a channel
   map: a control slot of AFSK codewords (ALH and GTC) whose GTC grants a
   channel whose slot is left free, FM voice there and on the other 1021
   slots, 2 + 3 chunks. ALH and GTC must be decoded on the control slot,
   the grant followed, audio produced on the granted slot, and the
   bit-timing kernel launched once per chunk;
13. the per-slot C4FM path (``bank_mode`` left to its default) at the same
   width and 31 slots, the most it keeps off the bank tier: a control
   channel granting a free slot and 29 voice slots, 3 + 4 chunks, an IQ
   tap and a bits tap through the timed chunks, then a change to 6.4 MS/s
   and one chunk on the rebuilt receiver; the grant followed, frames on
   every voice slot, AudioSegments, one DQPSK launch a chunk;
14. the same with ``decoder="p25p2"``: the key the control slot learns
   handed to the granted slot, fragments on every voice slot, one Gardner
   (W = 16) launch a chunk;
15. banks=[("c4fm", 11), ("dmr", 10), ("ltr", 10)] behind one channelizer,
   chunks of 1024 x 6250, 2 + 4: the P25 grant followed, frames on every
   C4FM and DMR voice slot, CALL words of each LTR slot's own group and
   audio, one DQPSK launch a chunk at gain 0.3 and one at 0.4, one
   bit-timing launch;
16. phase 5's bank with host_process=True, 2 + 3 chunks, phase 5's checks,
   and no CUDA context in the worker process;
17. ``cli``: the entry point users run, ``sdrtrunk_tpu_torch.cli.main``,
   in this process: ``decode`` of a P25 Phase 1, DMR, P25 Phase 2, LTR
   and MPT1327 capture (25 kHz, about 0.5 s each), of the P25 Phase 1
   capture at 48 kHz (decoded at its rate: DQPSK at W = 20) and ``replay`` of
   tests/test_cli.py's two-channel P25 capture, each on the card and
   again with ``--platform cpu``: the same message lines, one launch a
   decode (DQPSK at gain 0.3 and 0.4 and at W = 20, Gardner W = 16, bit
   timing W = 53 and 12), one DQPSK launch at C = 2 for the replay, none
   on the CPU;
   then each kernel held against its plain loop at the shape the CLI gave
   it;
18. ``monitor``: phase 5's scene written as a 16-bit IQ wave (3 + 4
   chunks, about 147 MB), a playlist of its control channel alone, and
   ``monitor --bank --traffic-slots 1022``: 1023 slots in bank mode, the
   grant in the event log and followed (frames on the granted slot), a
   call written as WAV and sidecar, 7 DQPSK launches at C = 1023;
19. ``monitor_mixed``: a playlist of a P25, a DMR and an LTR control
   channel, ``--traffic-slots 4``: banks [(c4fm, 5), (dmr, 5), (ltr, 5)];
   each control channel decodes, both grants are followed (the P25 one
   decoded), every call is written as a parsable MPEG-1 Layer II file,
   the P25 channel's bits tap re-frames to TSBKs, one launch a chunk at
   gain 0.3, 0.4 and W = 53;
20. ``parity``: the per-channel decode path (``dec(x, state)`` on one
   channel's 1-D block, each kernel at C = 1). The golden captures:
   ``parity.write_golden`` writes .bits files and a manifest equal in
   bytes to tests/golden/ (the float64 host oracle), and the card's
   decode of each capture (C4FM and LSM about 4760 samples, DMR about
   7050) frames manifest.json's events. The reference's four parity
   reports (C4FM clean and at 12 dB, DMR, the Gardner LSM) with the device
   half on the card, each held to the reference's pass rule. The NBFM,
   AM, LTR and MPT1327 per-channel calls on the card against the CPU's
   (bits and valid exact, audio within 1e-4). A checkpoint round trip:
   a C4FM decode in two chunks, saved after the first and resumed from
   the file, bit for bit the same as without the save. tests/test_p25p2.py's
   modem scene through P25P2Config(timing="decision"): the fragment
   framed with its MAC octets and voice frames. LTR decodes of 0.5 s of
   16 and 48 kHz FSK audio through LTRDecoder(LTRConfig(audio_rate=...)):
   the sent bits back. Launches: DQPSK 6 at gain 0.3 and 2 at 0.4 (W =
   10) and 1 at W = 16, Gardner 2 at W = 11, bit timing 1 at W = 53, 1 at
   W = 12, 1 at W = 106 and 1 at W = 320;
21. ``receiver``: ``WidebandReceiver.build()`` (the static plan) at full
   width on phase 5's C4FM scene, 1023 channels, 1 + 4 chunks of 1024 x
   5120 as device-resident float32 pairs: its MS/s and realtime factor
   (host clock around work that ends in a synchronize), outputs and state
   equal to ``build_dynamic()``'s with the plan's bins and steps bit for
   bit, TSBKs on the control slot and frames on >= 99% of the sampled
   voice slots, one DQPSK launch a chunk; a 25 kHz NBFM channel between
   two bins through ``build()`` with ``channel_bandwidths`` (the tone
   within 20 Hz); the oscillator, CIC, Goertzel, biquad (1023 x 10240
   float32), CMA (20000 QPSK samples through a static channel), IQ
   correction, Hilbert and two-bin synthesizer on the card against the
   CPU within tests/test_torch_misc_dsp.py's tolerances, one biquad and
   one CMA launch; then the biquad and the CMA kernels held bit for bit
   against their plain versions on the card on the same inputs, timed by
   CUDA events beside their bytes bound and their chain's floor, and
   again on complex64 rows (1023 x 10240) and at 32 taps, each of these
   also against the CPU within the same tolerances;
22. ``parallel``: the sharded channelizer pipeline over torch.distributed
   at world size 1 over NCCL (one card gives one rank): ``python -m
   sdrtrunk_tpu_torch.parallel.multiprocess --device cuda`` as a process
   must report ok and streaming_ok; then ``ShardedChannelizerPipeline``
   in this process on the receiver phase's plan (1023 C4FM channels,
   12.8 MS/s, M = 1024), 1 + 4 chunks of 1024 x 5120 complex64 on the
   card, ``build()`` and ``build_streaming()`` held against the
   single-device Channelizer + extract_channels (bit for bit, else within
   5e-5), ms a chunk and MS/s beside the single-device path's ms and the
   ``all_to_all_single``'s; no kernel launches. The group is destroyed
   before the phase returns.
23. ``bench``: the port's bench.py, ``bench_torch.py``: ``--smoke`` in a
   subprocess (the channelizer, the DQPSK and Gardner kernels at C = 1,
   the bit-timing kernel through the LTR demodulator, de-emphasis, the
   resampler and the two-channel synthesizer on the card against the
   CPU), every family passing; then its ``bench_receiver`` for NBFM and
   C4FM at full width (1023 channels, 1024 x 5120 chunks, 24 timed
   iterations after the first call) in this process, their MS/s and
   ``roofline_nbfm``; 25 DQPSK launches, all from the C4FM leg.
24. ``reference``: the port held against the JAX package at full width.
   tests/torch_reference/banks_1023.json holds the JAX package's own
   decode of bench.py's five bank legs (C4FM in int8 and in int4, DMR,
   P25 Phase 2, NBFM; 1023 slots, 3 + 6 chunks of 1024 x 5120, NBFM 2 + 6
   of 1024 x 6400) as digests (tools/reference_digests.py writes it on a
   CPU with JAX). For each bank, bench_torch's scene builder rebuilds the
   scene on the host (bench.py's NumPy synthesis, the same operations in
   the same order) and every chunk's sha256 must equal the file's before
   anything runs; then ``bench_torch.run_bank`` runs the port's
   Orchestrator(device="cuda") on it as the bench leg does, and
   ``bench_torch.compare_digests`` holds its digest slot by slot to the
   reference's within the bank's tolerance in the file. Prints each
   bank's record (its realtime factor), its totals beside the
   reference's, and every slot that differs with both values; one DQPSK
   launch a chunk for the C4FM banks (gain 0.3) and DMR (0.4), one
   Gardner (W = 16) launch a chunk for P25 Phase 2, none for NBFM. The
   same holds the live cells (tests/torch_reference/cells_full_width.json:
   LTR, MPT1327, LSM, AM, C4FM on 25 kHz channels) and the paths
   (paths_full_width.json): the main path's own scene (phase 5's 1023-slot
   C4FM bank, its grant of channel 600; ``c4fm_grant``), the same bytes
   with ``host_process=True`` (``worker``: what its parent sees held to
   the reference's own worker's and, field for field, to the port's
   in-process view but where the reference's worker parts from its
   in-process bank), the per-slot C4FM path at 31 slots with its IQ and
   bits taps and a sample-rate change to 6.4 MS/s (one more DQPSK launch
   at 31 x 32), the per-slot P25 Phase 2 path (its key learned and handed
   to the grant) and the 31-slot multibank (one launch a chunk of DQPSK at
   gain 0.3 and 0.4 and of the bit timing at W = 53), each cell's and
   path's bytes rebuilt on the host by ``bench_torch.cell_bytes``, its
   events held too; and ``c4fm_ppm``, the main path's bytes through a
   tuner reading +0.7 ppm with the PPM correction on and a 0.4 s window:
   the correction fires in the second warm-up chunk and retunes all 1023
   slots while the third is in flight, and its chunk, value, every
   metrics line's correction and PLL error and the retuned plan are held
   (``compare_ppm``), the retune's host ms and the firing chunk's wall ms
   printed. Last, ``monitor``: the CLI (``monitor --bank
   --traffic-slots 1022``, every other setting at its default) on the
   main path's bytes as a 16-bit IQ wave whose sha256 must equal the
   file's, what it wrote (event log, call files and sidecars, metrics and
   summary lines) held to the JAX CLI's, the PLL error within the file's
   bound; then ``monitor_mixed``: phase 19's scene rebuilt on the host
   (``bench_torch.mixed_monitor_inputs``), the CLI's event log, bits tap,
   lines and mp2 calls held to the JAX CLI's (the frames of each call
   that may differ bounded), and the PCM swap held: the port's PCM of
   each call within 1e-6 of the reference's own, and that PCM through
   the port's encoder on the card within its bound of the reference's
   frames and byte for byte the same encoder's on the CPU. A missing
   file, a chunk hash that differs or a digest outside its tolerance
   fails the run.

``channelize`` (after phase 4): the channelizer's branch-sum kernel at the
bank cells' shapes (M = 1024, T = 9, K = 40960 and 51200, the designed
prototype, a nonzero history), its u and ``channelize_core``'s y bit for
bit against the plain versions on the card; the kernel through its wrapper
by CUDA events, its device ms behind a sleep, beside its bytes bound (the
padded input and the branches read once, u written once), the plain sums'
ms, and the whole layer (sums, inverse FFT, the odd blocks' flip) both
ways. Every path channelizes through the kernel, a live loop's step once
a chunk: its launches are counted as every other kernel's are (below).

During every live phase (5-24, 5a) a spy on the calls that reach the kernel
wrappers records the (kernel, C, T) of each launch on the card; after the
phase, each shape it recorded is held bit for bit against its plain loop
as phase 4 holds the 1023-channel ones, unless this run held that shape
already (phases 5, 6, 8, 11, 12, 16, 18, 23 and 24 give phase 4's shapes).

Phases 17-20 write their captures, playlists, what the CLI writes, the
golden set and the checkpoint under the git-ignored
``.scratch/chip_smoke/`` and remove them after; phase 22 its process
groups' rendezvous files under ``.scratch/``.

Every live loop prints its realtime factor, wall and host ms a chunk (the
host layer: the bank framer's ``frame_chunk`` for the digital kinds,
``route_audio`` for the analog ones, ``route_mixed`` for the
analog-trunking ones, the per-slot processors' ``_route_slots`` on the
per-slot path and with banks=, the worker's round trip ``process_chunk``),
its device layers, and the device's busy ms and idle share.

The script imports nothing of the JAX package: its signals and protocol
encoders are the port's own copies (sdrtrunk_tpu_torch.signal,
sdrtrunk_tpu_torch.protocol).

Each live loop resets every kernel's launch counts just before it runs and
reads them just after. A wrapper counts a launch in all and under its
loop's timing gain and window length (DQPSK) or window length (Gardner,
bit timing), row dtype (biquad), tap count (CMA) or input dtype (the
channelizer), so each entry of the kernels line (C4FM, DMR, P25P2
decision-timed and W = 20 DQPSK, P25P2 and LSM Gardner, LTR, AFSK, 16 and
48 kHz LTR bit timing, the biquad, the CMA, the channelizer) has its own
count from the launch itself. At the end
the script prints its own run time, then the kernels' JSON record on the
line before the last (the kernels a run checked; an entry's ``launches``
is the sum over the live loops that ran it, ``launches_by_path`` each
loop's count, ``launches`` null where no live loop ran it, and ``holds``
each live loop's shapes with the phase that held them and that hold's
numbers); the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FS = 12_800_000.0
M = 1024
SLOTS = 1023
CHUNK_BLOCKS = 5120
WARMUP, TIMED = 3, 4
CENTER_HZ = 460_000_000.0
TRAFFIC_INDEX = 600              # the granted channel's slot offset index
GROUP, SOURCE = 0x457, 0xABCDE
KERNEL_C, KERNEL_T = 1023, 10240
NOISE_CHANNELS = 8
P25P2_KEY = (0xA4BC3, 0x123, 0x29A)            # WACN, system, NAC
LSM_SLOTS, LSM_CHUNKS = 64, 3
ANALOG_BLOCKS = 6400             # K = 12800 channel samples (bench.py:697)
NBFM_WARMUP, NBFM_TIMED = 2, 4
NBFM_TONE_HZ, AM_TONE_HZ = 700.0, 1000.0
AM_SLOTS, AM_CHUNKS = 64, 3
MIXED_BLOCKS = 6250              # K = 12500 channel samples, Ka = 4000
LTR_WARMUP, LTR_TIMED = 2, 4
MPT_WARMUP, MPT_TIMED = 2, 3
MPT_TRAFFIC_INDEX = 300          # a GTC channel number is below 512
VOICE_TONE_HZ = 800.0
BIT_T = {"ltr": 4000, "afsk": 3600,   # a live chunk's samples a slot
         "w106": 8000, "w320": 12000}   # 0.5 s at 16 kHz, 0.25 s at 48 kHz
# LTR's demodulator at audio rates whose delay line is more than one of the
# bit-timing kernel's 64-bit words, W = floor(2 * rate / 300): 16 kHz (W =
# 106) and a sound card's 48 kHz (W = 320)
WIDE_BIT_RATES = {"w106": 16000.0, "w320": 48000.0}
SLOT_COUNT = 31                  # the most slots bank_mode=None runs per slot
SLOTS_TRAFFIC_INDEX = 300        # the channel their control channel grants
MULTIBANK = [("c4fm", 11), ("dmr", 10), ("ltr", 10)]
MB_WARMUP, MB_TIMED = 2, 4
WORKER_WARMUP, WORKER_TIMED = 2, 3


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _cuda_ms(fn, reps: int = 1) -> float:
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# cycles of the sleep kernel that holds the stream while the host queues
# the calls ``_device_span_ms`` times: 0.1 s at an H100's 1.98 GHz
HOLD_QUEUE_CYCLES = 200_000_000


def _device_span_ms(fn, reps: int = 20) -> float:
    """Mean device ms of a call of fn, by CUDA events around `reps` calls
    queued behind a sleep kernel: the card waits on the sleep until the
    host has queued every call, so the events time the calls' device work
    back to back and not the host's enqueue (a few hundred us of Python a
    call through a wrapper). Raises if the sleep ended before the host had
    queued the last call."""
    import torch

    fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    held.record()
    t0 = time.perf_counter()
    torch.cuda._sleep(HOLD_QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if held.elapsed_time(start) <= queued_ms:
        raise AssertionError(f"the sleep held the stream "
                             f"{held.elapsed_time(start):.1f} ms, the host "
                             f"took {queued_ms:.1f} ms to queue {reps} calls")
    return start.elapsed_time(end) / reps


def _launch_counters():
    from sdrtrunk_tpu_torch.dsp.biquad_cuda import biquad_cuda
    from sdrtrunk_tpu_torch.dsp.bit_timing_cuda import bit_timing_cuda
    from sdrtrunk_tpu_torch.dsp.channelize_cuda import channelize_cuda
    from sdrtrunk_tpu_torch.dsp.cma_cuda import cma_cuda
    from sdrtrunk_tpu_torch.dsp.dqpsk_cuda import dqpsk_cuda
    from sdrtrunk_tpu_torch.dsp.gardner_cuda import gardner_cuda
    return {"dqpsk": dqpsk_cuda, "gardner": gardner_cuda,
            "bit_timing": bit_timing_cuda, "biquad": biquad_cuda,
            "cma": cma_cuda, "channelize": channelize_cuda}


# the kernels line's entries, in its order: (the wrapper whose launches
# they are, the key its ``launches_by`` counts them under: the DQPSK timing
# gain and window length, the Gardner and bit-timing window lengths, the
# biquad's row dtype, the CMA's tap count and the channelizer's input
# dtype, complex64 at every launch)
_ENTRY_KEYS = {"dqpsk": ("dqpsk", (0.3, 10)),
               "gardner_p25p2": ("gardner", 16),
               "gardner_lsm": ("gardner", 11),
               "dqpsk_dmr": ("dqpsk", (0.4, 10)),
               "bit_timing_ltr": ("bit_timing", 53),
               "bit_timing_afsk": ("bit_timing", 12),
               "dqpsk_p25p2": ("dqpsk", (0.3, 16)),
               "dqpsk_w20": ("dqpsk", (0.3, 20)),
               "bit_timing_w106": ("bit_timing", 106),
               "bit_timing_w320": ("bit_timing", 320),
               "biquad": ("biquad", "float32"),
               "cma": ("cma", 11),
               "channelize": ("channelize", "complex64")}


def _reset_launches() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0
        fn.launches_by.clear()


def _read_launches() -> dict:
    """Each entry's launches since the last reset, as its wrapper counted
    them at the launch. Raises if a wrapper launched under a key that no
    entry names."""
    counters = _launch_counters()
    got = {entry: counters[name].launches_by[key]
           for entry, (name, key) in _ENTRY_KEYS.items()}
    for name, fn in counters.items():
        named = sum(got[e] for e, (n, _) in _ENTRY_KEYS.items() if n == name)
        if fn.launches != named:
            raise AssertionError(f"{name}: {fn.launches} launches, "
                                 f"{named} of them under the entries' keys "
                                 f"({dict(fn.launches_by)})")
    return got


# --- phase 2: build -------------------------------------------------------

def _windows_of(g: int, k: int) -> str:
    """The window lengths the symbol loops launch at lane layout (g, k)."""
    from sdrtrunk_tpu_torch.dsp.nvcc import MAX_WINDOW, MIN_WINDOW, lane_layout
    ws = [w for w in range(MIN_WINDOW, MAX_WINDOW + 1)
          if lane_layout(w)[:2] == (g, k)]
    return f"{ws[0]}-{ws[-1]}"


def build_kernels() -> dict:
    """Build the kernel libraries in parallel, one nvcc each; prints each
    library's build time and returns ptxas's registers and spills per
    kernel instantiation (a symbol loop's lane layout (G, K), with the
    window lengths it serves)."""
    from concurrent.futures import ThreadPoolExecutor

    from sdrtrunk_tpu_torch.dsp import (biquad_cuda, bit_timing_cuda,
                                        channelize_cuda, cma_cuda,
                                        dqpsk_cuda, gardner_cuda, nvcc)

    def timed(m):
        t1 = time.perf_counter()
        m.build()
        return time.perf_counter() - t1

    t0 = time.perf_counter()
    mods = {"dqpsk": dqpsk_cuda, "gardner": gardner_cuda,
            "bit_timing": bit_timing_cuda, "biquad": biquad_cuda,
            "cma": cma_cuda, "channelize": channelize_cuda}
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {n: pool.submit(timed, m) for n, m in mods.items()}
        each = {n: round(f.result(), 2) for n, f in futures.items()}
    print(f"[build] {', '.join(mods)} kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (each, in parallel: "
          f"{json.dumps(each)} s)", flush=True)
    regs = {}
    for name in mods:
        entry = None
        for line in nvcc.ptxas_report(name).splitlines():
            m = re.search(r"Compiling entry function '.*?(dqpsk|gardner)"
                          r"_kernelILi(\d+)ELi(\d+)E", line)
            if m:
                g, k = int(m.group(2)), int(m.group(3))
                entry = f"{m.group(1)}<G={g},K={k}>"
                regs[entry] = {"windows": _windows_of(g, k)}
            # bit timing by its line's 64-bit words L (W <= 64 L), the
            # biquad by its floats a sample (1 float32, 2 complex64) and its
            # copies (1 bulk), the CMA by its tree's width P
            m = re.search(r"Compiling entry function '.*?(bit_timing|biquad)"
                          r"_kernelILi(\d+)E(?:Lb(\d)E)?", line)
            if m:
                entry = (f"bit_timing<L={m.group(2)}>"
                         if m.group(1) == "bit_timing"
                         else f"biquad<V={m.group(2)},bulk={m.group(3)}>")
            m = re.search(r"Compiling entry function '.*?cma_kernelILi(\d+)E",
                          line)
            if m:
                entry = f"cma<P={m.group(1)}>"
            if re.search(r"Compiling entry function '.*?channelize_kernel",
                         line):
                entry = "channelize"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry:
                regs.setdefault(entry, {})["spill_stores"] = int(m.group(1))
                regs[entry]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                regs.setdefault(entry, {})["registers"] = int(m.group(1))
                entry = None            # what follows is a helper's
    print("[build] ptxas " + json.dumps(regs), flush=True)
    if any(v.get("spill_stores", 0) or v.get("spill_loads", 0)
           for v in regs.values()):
        raise AssertionError(f"a kernel spills registers: {regs}")
    return regs


# --- phases 3-4: the kernels against their plain versions -----------------

# the symbol loops at the shapes their live loops give them:
# (name, kernel, sample rate, baud, timing gain, T)
KERNELS = (("dqpsk", "dqpsk", 25000.0, 4800.0, 0.3, KERNEL_T),
           ("gardner_p25p2", "gardner", 50000.0, 6000.0, 0.1, 2 * KERNEL_T),
           ("gardner_lsm", "gardner", 25000.0, 4800.0, 0.3, KERNEL_T),
           ("dqpsk_dmr", "dqpsk", 25000.0, 4800.0, 0.4, KERNEL_T),
           # P25 Phase 2 on the decision-directed loop (W = 16), at the
           # P25P2 bank's 50 kHz channel width and tests/test_p25p2.py's gain
           ("dqpsk_p25p2", "dqpsk", 50000.0, 6000.0, 0.3, 2 * KERNEL_T),
           # C4FM on 25 kHz channels (50 kHz, W = 20): the c4fm_25k bank
           ("dqpsk_w20", "dqpsk", 50000.0, 4800.0, 0.3, KERNEL_T))
# the other window lengths check_edges holds, with KERNELS both kernels
# at each: captures at 32, 48, 64, 96 and 192 kHz and 25 kHz channels
# (50 kHz)
# (name, kernel, sample rate, baud, timing gain)
EDGE_WIDTHS = (("dqpsk_w13", "dqpsk", 32000.0, 4800.0, 0.3),
               ("gardner_w13", "gardner", 32000.0, 4800.0, 0.3),
               ("gardner_w20", "gardner", 48000.0, 4800.0, 0.3),
               ("dqpsk_w21", "dqpsk", 51200.0, 4800.0, 0.4),
               ("gardner_w21", "gardner", 64000.0, 6000.0, 0.1),
               ("dqpsk_w32", "dqpsk", 76800.0, 4800.0, 0.3),
               ("gardner_w32", "gardner", 96000.0, 6000.0, 0.1),
               ("dqpsk_w40", "dqpsk", 96000.0, 4800.0, 0.3),
               ("gardner_w40", "gardner", 96000.0, 4800.0, 0.3),
               ("dqpsk_w80", "dqpsk", 192000.0, 4800.0, 0.3),
               ("gardner_w80", "gardner", 192000.0, 4800.0, 0.3))
_SOURCES = {"dqpsk": ("sdrtrunk_tpu_torch/csrc/dqpsk.cu",
                      "sdrtrunk_tpu/dsp/pallas_psk.py:48"),
            "gardner": ("sdrtrunk_tpu_torch/csrc/gardner.cu",
                        "sdrtrunk_tpu/dsp/pallas_gardner.py:50")}
# H100 SXM peaks (NVIDIA's data sheet): device memory, float64 outside the
# tensor cores (the loops' float64 products and sums, cos, sin and sqrt)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# operations of a sample (the mix with cos and sin counted one each, the
# phase wrap, the sampling-point count) and of a symbol step, counted from
# csrc/*.cu
OPS_PER_SAMPLE = 13
OPS_PER_SYMBOL = {"dqpsk": 70, "gardner": 100}
EDGE_C, EDGE_T, EDGE_SPLIT = 37, 997, 400


def _symbol_loop(kind: str, rate: float, baud: float, gain: float):
    from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator,
                                            GardnerDQPSKDemodulator)
    cls = DQPSKDemodulator if kind == "dqpsk" else GardnerDQPSKDemodulator
    return cls(rate, baud, gain, device="cuda")


def _modulator(kind: str):
    from sdrtrunk_tpu_torch.signal.generators import (c4fm_modulate,
                                                      lsm_modulate)
    if kind == "dqpsk":
        return lambda d, rate, baud: c4fm_modulate(d, rate, baud)
    return lambda d, rate, baud: lsm_modulate(d, sample_rate=rate,
                                              symbol_rate=baud)


def _fresh_state(demod, c: int):
    s = demod.init_state()
    return type(s)(*[a.expand((c,) + a.shape).clone() for a in s])


def _noise_channels(c: int) -> int:
    """The noise-only channels at the end of a kernel check's c channels."""
    return min(NOISE_CHANNELS, c // 8)


def _signal_block(modulate, t: int, rate: float, baud: float,
                  c: int = KERNEL_C):
    """(c, t) complex64 on the card: channels of a modulated random-dibit
    stream at 30 dB from random offsets, then the noise-only ones (1015
    and 8 of 1023)."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.signal.generators import awgn, random_dibits

    rng = np.random.default_rng(1)
    sym = int(t * baud / rate)
    bases = [modulate(random_dibits(sym + 2400, seed=s), rate, baud)
             for s in range(4)]
    n_noise = _noise_channels(c)
    rows = []
    for ch in range(c - n_noise):
        base = bases[ch % 4]
        s = int(rng.integers(0, len(base) - t))
        rows.append(awgn(base[s:s + t], 30.0, rng=rng))
    noise = (rng.standard_normal((n_noise, t))
             + 1j * rng.standard_normal((n_noise, t))) * 0.5
    return torch.as_tensor(np.concatenate([np.stack(rows), noise])
                           .astype(np.complex64), device="cuda")


def _hold(name: str, kernel_out, plain_out, fields) -> float:
    """Kernel against plain, bit for bit on every channel: dibits, valid
    and every state leaf. Returns the max state error (0.0)."""
    import torch

    got = (kernel_out[0], kernel_out[1], *kernel_out[2])
    want = (plain_out[0], plain_out[1], *plain_out[2])
    for what, a, b in zip(("dibits", "valid", *fields), got, want):
        if not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(1).nonzero()
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 f"plain loop on channels "
                                 f"{bad.flatten().tolist()[:10]}")
    return max(float((a - b).abs().max()) for a, b in zip(got[2:], want[2:]))


def _warp_symbol_share(valid) -> float:
    """Share of (sample, warp of 32 consecutive channels) pairs on which a
    channel of the warp has a symbol due: how often a warp of the
    per-sample layout (one lane a channel) took the symbol path."""
    import torch

    c, t = valid.shape
    pad = torch.zeros(((-c) % 32, t), dtype=torch.bool, device=valid.device)
    return float(torch.cat([valid, pad]).reshape(-1, 32, t).any(1)
                 .float().mean())


def _bound(kind: str, x, state, symbols: int) -> tuple[float, str]:
    """The least time the card could take for the same work: each input
    read once and each output written once (x, the bank, the state in and
    out, the (T, C) bytes) over the memory rate, or the operations this
    run's symbols need over the float64 rate, whichever is longer."""
    c, t = x.shape
    nbytes = (x.numel() * x.element_size() + t * c + 129 * 8 * 4
              + 2 * sum(a.numel() * a.element_size() for a in state))
    ops = c * t * OPS_PER_SAMPLE + symbols * OPS_PER_SYMBOL[kind]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP64_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def check_kernel(card: str, name: str, kind: str, rate: float, baud: float,
                 gain: float, t: int, c: int = KERNEL_C) -> dict:
    """A kernel against its plain loop at a live shape (c, t), reached
    through ``batched``, and timed beside its bound."""
    from sdrtrunk_tpu_torch.dsp import dqpsk_cuda, gardner_cuda

    wrapper = {"dqpsk": dqpsk_cuda.dqpsk_cuda,
               "gardner": gardner_cuda.gardner_cuda}[kind]
    demod = _symbol_loop(kind, rate, baud, gain)
    s0 = _fresh_state(demod, c)
    x = _signal_block(_modulator(kind), t, rate, baud, c)
    kernel = demod.batched(x, s0)
    plain = {}

    def run_plain():
        plain["out"] = demod.scan_batched(x, s0)
    plain_ms = _cuda_ms(run_plain)
    kernel_ms = _cuda_ms(lambda: wrapper(demod, x, s0), reps=5)
    err = _hold(name, kernel, plain["out"], type(s0)._fields)
    valid = kernel[1]
    # the loop takes a symbol every rate / baud samples, on noise too: at
    # least 0.1 a sample, or half its rate where that is below 0.1 (W = 20)
    floor = 0.1 if baud >= 0.1 * rate else 0.5 * baud / rate
    if float(valid.float().mean()) < floor:
        raise AssertionError(f"{name}: kernel produced too few symbols")
    bound_ms, bound_by = _bound(kind, x, s0, int(valid.sum()))
    share = _warp_symbol_share(valid)
    print(f"[kernel] {card}: {name} W={demod.window_len} C={c} T={t}: "
          f"identical to the plain loop on all {c} channels (dibits, valid, "
          f"every state leaf; max state err {err}); kernel {kernel_ms:.3f} "
          f"ms against a {bound_ms:.4f} ms {bound_by} bound "
          f"({100 * bound_ms / kernel_ms:.2f}% of it), plain "
          f"{plain_ms:.1f} ms; (sample, warp of 32 channels) pairs with a "
          f"symbol due {100 * share:.1f}%", flush=True)
    source, replaces = _SOURCES[kind]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": [c, t], "plain_shape": [c, t],
            "warp_symbol_share": share}


def _edge_block(kind: str, rate: float, baud: float):
    """(37, 997) complex64 on the card: channels 0-31 at symbol rates
    spread over +/-2% (the lanes of a warp drift apart), the rest at the
    nominal rate; 997 is prime, so no run length divides it."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.signal.generators import awgn, random_dibits

    rng = np.random.default_rng(2)
    modulate = _modulator(kind)
    rows = []
    for i in range(EDGE_C):
        b = baud * (1.0 + 0.02 * (2.0 * i / 31 - 1.0)) if i < 32 else baud
        dib = random_dibits(int(EDGE_T * b / rate) + 16, seed=100 + i)
        rows.append(awgn(modulate(dib, rate, b)[:EDGE_T], 30.0, rng=rng))
    return torch.as_tensor(np.stack(rows).astype(np.complex64),
                           device="cuda")


def check_edges(card: str) -> None:
    """The cases the symbol-major loop creates, each kernel held bit for
    bit against its plain loop at each live width (KERNELS) and at
    EDGE_WIDTHS: C = 37 (not a multiple of a warp), a warp whose channels
    drift apart, T = 997 and T = 1, a symbol due at t = 0 on every third
    channel, and two calls with carried state."""
    import torch

    from sdrtrunk_tpu_torch.dsp.nvcc import lane_layout

    loops = [k[:5] for k in KERNELS] + list(EDGE_WIDTHS)
    widths = {}
    for name, kind, rate, baud, gain in loops:
        demod = _symbol_loop(kind, rate, baud, gain)
        widths.setdefault(kind, {})[name] = (demod.window_len,
                                             *lane_layout(demod.window_len))
        x = _edge_block(kind, rate, baud)
        s0 = _fresh_state(demod, EDGE_C)
        s0.sampling_point[::3] = 1.5
        fields = type(s0)._fields
        plain = demod.scan_batched(x, s0)
        _hold(f"{name} C={EDGE_C} T={EDGE_T}", demod.batched(x, s0), plain,
              fields)
        _hold(f"{name} T=1", demod.batched(x[:, :1], s0),
              demod.scan_batched(x[:, :1], s0), fields)
        d1, v1, s1 = demod.batched(x[:, :EDGE_SPLIT], s0)
        d2, v2, s2 = demod.batched(x[:, EDGE_SPLIT:], s1)
        _hold(f"{name} two calls", (torch.cat([d1, d2], 1),
                                    torch.cat([v1, v2], 1), s2), plain, fields)
        if not bool(plain[1][::3, 0].all()):
            raise AssertionError(f"{name}: no symbol at t = 0 where one was "
                                 "due")
    print(f"[edges] {card}: {', '.join(k[0] for k in loops)} identical to "
          f"their plain loops at C={EDGE_C} with symbol rates spread +/-2%, "
          f"T={EDGE_T} and T=1, a symbol due at t=0, and two calls "
          f"({EDGE_SPLIT} + {EDGE_T - EDGE_SPLIT}) with carried state; "
          f"(W, G, K, ring) {json.dumps(widths)}", flush=True)


# --- the bit-timing kernel against its plain loop -------------------------

# peak float32 rate outside the tensor cores (NVIDIA's data sheet): the
# loop's compares, counts and the counter update
FP32_OPS_PER_S = 67e12
# a sample's and a symbol step's operations a 64-bit word of the line
BIT_OPS_PER_SAMPLE, BIT_OPS_PER_SYMBOL = 6, 24       # from bit_timing.cu
BIT_SOURCE = "sdrtrunk_tpu_torch/csrc/bit_timing.cu"


def _bit_demod(which: str):
    """The demodulator whose public call reaches the kernel, and the line
    of the reference scan it replaces: ``ltr`` at 8 kHz, ``w106`` and
    ``w320`` at WIDE_BIT_RATES, ``afsk``."""
    from sdrtrunk_tpu_torch.dsp.afsk import AFSK1200Demodulator
    from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator
    if which == "afsk":
        return (AFSK1200Demodulator(device="cuda"),
                "sdrtrunk_tpu/dsp/afsk.py:129")
    return (LTRFSKDemodulator(sample_rate=WIDE_BIT_RATES.get(which, 8000.0),
                              device="cuda"), "sdrtrunk_tpu/dsp/fsk.py:108")


def _square_fsk(bits, n: int, sps: float, start):
    """(C, n) float32 on the card: +/-1 by the bits (C, B) at sps samples a
    bit, read from sample offset start (C,) and wrapped around
    (``bench_torch._square_fsk``)."""
    import torch

    import bench_torch
    return torch.as_tensor(bench_torch._square_fsk(
        bits.cpu().numpy(), 0, n, sps, start.cpu().numpy()),
        dtype=torch.float32, device="cuda")


def _bit_audio(which: str, c: int, t_out: int):
    """(c, T) audio on the card whose demodulator front gives t_out
    samples to the timing loop: LTR (8 kHz, or WIDE_BIT_RATES), sub-audible
    square FSK at 300 baud (+/-0.35) under an 800 Hz tone and noise; AFSK
    (8 kHz), phase-continuous 1200 / 1800 Hz tones at 1200 baud with noise.
    The last 8 channels are noise only (fewer below 64 channels,
    ``_noise_channels``) and the one before them all zero (none when c is
    1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    t = t_out * 10 // 9 if which == "afsk" else t_out
    bits = torch.as_tensor(rng.integers(0, 2, (c, 997)), device="cuda")
    start = torch.as_tensor(rng.integers(0, 8000, c), device="cuda")
    n = torch.arange(t, device="cuda", dtype=torch.float64)[None, :]
    if which != "afsk":
        rate = WIDE_BIT_RATES.get(which, 8000.0)
        data = 0.35 * _square_fsk(bits, t, rate / 300.0, start)
        tone = 0.5 * torch.sin(2 * np.pi * VOICE_TONE_HZ / rate * n
                               + start[:, None])
        x = data + tone.float()
    else:
        mark = _square_fsk(bits, t, 8000.0 / 1200.0, start) > 0
        freq = torch.where(mark, 1200.0, 1800.0).double()
        x = 0.5 * torch.sin(2 * np.pi / 8000.0 * torch.cumsum(freq, 1)
                            ).float()
    x = x + 0.02 * torch.randn((c, t), device="cuda", generator=gen)
    n_noise = _noise_channels(c)
    if c > 1:                           # one channel carries the signal
        x[c - n_noise - 1] = 0.0
    x[c - n_noise:] = 0.2 * torch.randn((n_noise, t), device="cuda",
                                        generator=gen)
    return x


def _hold_bits(name: str, got, want) -> float:
    """Kernel against plain, bit for bit on every channel: bits, valid,
    window and sampling point. Returns the sampling point's max error
    (0.0)."""
    import torch
    for what, a, b in zip(("bits", "valid", "window", "sampling_point"),
                          got, want):
        if not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(1).nonzero()
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 f"plain loop on channels "
                                 f"{bad.flatten().tolist()[:10]}")
    return float((got[3] - want[3]).abs().max())


def check_bit_timing(card: str, which: str, c: int = KERNEL_C,
                     t: int | None = None) -> dict:
    """The bit-timing kernel at a live chunk's shape (c, T), T = BIT_T
    unless given: reached through the demodulator's public call, held bit
    for bit against the plain loop on the same slicer input, and timed
    beside its bound, a call through the wrapper and its device span
    (``_device_span_ms``)."""
    import torch

    from sdrtrunk_tpu_torch.convert import tree_map
    from sdrtrunk_tpu_torch.dsp.bit_timing import bit_timing_plain
    from sdrtrunk_tpu_torch.dsp.bit_timing_cuda import bit_timing_cuda

    t = BIT_T[which] if t is None else t
    demod, replaces = _bit_demod(which)
    geom, invert = demod.geometry, getattr(demod, "invert", False)
    s0 = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                  demod.init_state())
    audio = _bit_audio(which, c, t)
    before = bit_timing_cuda.launches
    bits, valid, s1 = demod.batched(audio, s0)
    if bit_timing_cuda.launches != before + 1:
        raise AssertionError(f"bit_timing {which}: the demodulator's call "
                             "did not launch the kernel once")
    x = demod.front(audio, s0)[0].contiguous()
    if tuple(x.shape) != (c, t):
        raise AssertionError(f"slicer input {tuple(x.shape)}, not {(c, t)}")
    plain = {}

    def run_plain():
        plain["out"] = bit_timing_plain(geom, x, s0.window,
                                        s0.sampling_point, invert)
    plain_ms = _cuda_ms(run_plain)

    def run_kernel():
        bit_timing_cuda(geom, x, s0.window, s0.sampling_point, invert)
    # a call through the wrapper (its allocations, the launch, the host's
    # enqueue) by CUDA events, as check_kernel times the others; the
    # kernel's device span beside it (the wrapper queues no other work)
    kernel_ms = _cuda_ms(run_kernel, reps=20)
    device_ms = _device_span_ms(run_kernel)
    name = f"bit_timing_{which}"
    err = _hold_bits(name, (bits, valid, s1.window, s1.sampling_point),
                     plain["out"])
    symbols = int(valid.sum())
    live = valid[:max(c - _noise_channels(c) - 1, 1)].sum(1)
    nominal = t / geom.sps
    if int(live.min()) < 0.9 * nominal or int(live.max()) > 1.1 * nominal:
        raise AssertionError(f"{name}: {int(live.min())}-{int(live.max())} "
                             f"symbols a channel, nominal {nominal:.0f}")
    nbytes = (x.numel() * 4 + 2 * c * t
              + 2 * (s0.window.numel() + 4 * c))
    ops = c * t * BIT_OPS_PER_SAMPLE \
        + symbols * BIT_OPS_PER_SYMBOL * -(-geom.window_len // 64)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = ((by_bytes, "bytes") if by_bytes >= by_ops
                          else (by_ops, "operations"))
    print(f"[kernel] {card}: {name} W={geom.window_len} C={c} T={t}: "
          f"identical to the plain loop on all {c} channels (bits, valid, "
          f"window, sampling point; max err {err}), {symbols} symbols; "
          f"kernel {kernel_ms:.4f} ms a call through the wrapper (CUDA "
          f"events; {device_ms:.4f} ms of it the kernel on the device, "
          f"queued behind a sleep) against a {bound_ms:.4f} ms {bound_by} "
          f"bound "
          f"({100 * bound_ms / kernel_ms:.2f}% of it), plain "
          f"{plain_ms:.1f} ms", flush=True)
    return {"name": name, "route": "cuda", "source": BIT_SOURCE,
            "replaces": replaces, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": [c, t], "plain_shape": [c, t],
            "symbols": symbols, "device_ms": device_ms}


def _window_with_crossings(w: int, zc_len: int, crossings):
    """(line (w,) int8, next decision): a delay line and the decision
    shifted in after it, so that the newest zc_len decisions zc then hold
    exactly the given crossings (crossing i lies between zc[i] and
    zc[i + 1]): the line's newest zc_len - 1 decisions are zc[:-1] and the
    next decision is zc[-1]."""
    import torch
    zc = torch.zeros(zc_len, dtype=torch.int8)
    level = 0
    for i in range(zc_len):
        zc[i] = level
        if i in crossings:
            level ^= 1
    line = torch.zeros(w, dtype=torch.int8)
    line[w - (zc_len - 1):] = zc[:-1]
    line[:w - (zc_len - 1)] = zc[0]
    return line, int(zc[-1])


def check_bit_timing_edges(card: str) -> None:
    """The loop's edge cases, the kernel held bit for bit against the plain
    loop, for the LTR geometry (at 8 kHz, and at 16 and 48 kHz, whose
    lines of W = 106 and 320 are two and five of the kernel's 64-bit
    words; at 48 kHz two crossings can lie at equal distance from the
    ideal), the AFSK geometry (also inverted) and the AFSK geometry with
    the two-crossing rule (where they can too): 37 channels, T = 997 and
    T = 1, a symbol due at t = 0 on every third channel, two calls with
    carried state, an all-zero channel, and channels whose window at t = 0
    holds exactly one crossing, exactly two, and two at equal distance,
    whose new sampling point is also held against the rule worked by
    hand."""
    import dataclasses

    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.dsp.bit_timing import bit_timing, bit_timing_plain

    ltr, afsk = _bit_demod("ltr")[0].geometry, _bit_demod("afsk")[0].geometry
    tie = dataclasses.replace(afsk, two_crossings=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for name, geom, invert in (("ltr", ltr, False), ("afsk", afsk, False),
                               ("afsk inverted", afsk, True),
                               ("afsk two-crossing rule", tie, False),
                               *((f"ltr {w}", _bit_demod(w)[0].geometry,
                                  False) for w in WIDE_BIT_RATES)):
        w, zl = geom.window_len, geom.zc_len
        # slow square waves of per-channel period with noise: crossings
        # come and go in the window
        period = torch.linspace(0.7, 1.6, EDGE_C, device="cuda")[:, None] \
            * 2.0 * geom.sps
        n = torch.arange(EDGE_T, device="cuda")[None, :]
        x = torch.sign(torch.sin(2 * np.pi * n / period + 0.3)) \
            + 0.3 * torch.randn((EDGE_C, EDGE_T), device="cuda",
                                generator=gen)
        x[5] = 0.0              # all-zero channel: its decisions never change
        window = (torch.rand((EDGE_C, w), device="cuda", generator=gen)
                  > 0.5).to(torch.int8)
        window[5] = int(invert)
        sp = torch.full((EDGE_C,), float(np.float32(geom.sps * 1.5)),
                        device="cuda")
        sp[::3] = 1.5
        # crafted windows, a symbol due at t = 0: one crossing, two (the
        # first nearer, then the last nearer), and two at equal distance
        mid = int(geom.zc_ideal)
        crafted = {0: [mid + 1], 3: [1, mid], 6: [mid, zl - 2],
                   9: [mid - 2, mid + 1]}
        want_sp = {}
        for ch, crossings in crafted.items():
            line, nxt = _window_with_crossings(w, zl, crossings)
            window[ch] = line.to("cuda")
            x[ch, 0] = 1.0 if nxt else -1.0
            k = geom.constants()
            errs = [np.float32(np.float32(i + 0.5) - np.float32(k["zc_ideal"]))
                    for i in crossings]
            if len(errs) == 1:
                e = errs[0]
            elif geom.two_crossings:
                e = errs[0] if abs(errs[0]) < abs(errs[1]) else errs[1]
            else:
                e = np.float32(0.0)
            base = np.float32(np.float32(0.5) + np.float32(k["sps"]))
            want_sp[ch] = np.float32(np.float64(e) * np.float64(k["gain"])
                                     + np.float64(base))
        if invert:                  # the line holds decisions as inverted
            for ch in crafted:
                x[ch, 0] = -x[ch, 0]
        plain = bit_timing_plain(geom, x, window, sp, invert)
        _hold_bits(f"{name} C={EDGE_C} T={EDGE_T}",
                   bit_timing(geom, x, window, sp, invert), plain)
        one = bit_timing(geom, x[:, :1], window, sp, invert)
        _hold_bits(f"{name} T=1", one,
                   bit_timing_plain(geom, x[:, :1], window, sp, invert))
        b1, v1, w1, sp1 = bit_timing(geom, x[:, :EDGE_SPLIT], window, sp,
                                     invert)
        b2, v2, w2, sp2 = bit_timing(geom, x[:, EDGE_SPLIT:], w1, sp1,
                                     invert)
        _hold_bits(f"{name} two calls", (torch.cat([b1, b2], 1),
                                         torch.cat([v1, v2], 1), w2, sp2),
                   plain)
        if not bool(plain[1][::3, 0].all()):
            raise AssertionError(f"{name}: no symbol at t = 0 where one "
                                 "was due")
        for ch, want in want_sp.items():
            got = float(one[3][ch])
            if got != float(want):
                raise AssertionError(
                    f"{name}: channel {ch} (crossings {crafted[ch]}) has "
                    f"sampling point {got}, the rule gives {float(want)}")
        # no crossing, error 0: a symbol every sps samples, all one bit
        at = plain[1][5].nonzero().flatten()
        steps = set((at[1:] - at[:-1]).tolist())
        if not steps <= {int(geom.sps), int(np.ceil(geom.sps))} \
                or not bool((plain[0][5][at] == int(invert)).all()):
            raise AssertionError(f"{name}: the all-zero channel's symbols "
                                 f"are {sorted(steps)} samples apart")
        cases.append(name)
    wide = ", ".join(str(_bit_demod(w)[0].window_len)
                     for w in WIDE_BIT_RATES)
    print(f"[edges] {card}: bit_timing identical to its plain loop for "
          f"{', '.join(cases)} (W = {wide} for the last two) at C={EDGE_C}, "
          f"T={EDGE_T} and T=1, a symbol due at t=0, two calls "
          f"({EDGE_SPLIT} + {EDGE_T - EDGE_SPLIT}) with carried state, an "
          "all-zero channel, and windows with one crossing, two, and two at "
          "equal distance from the ideal",
          flush=True)


# --- phases 5-7: the live loops -------------------------------------------

def _p25_streams(total_dibits: int, base_hz: float,
                 traffic_index: int = TRAFFIC_INDEX, **kw):
    """(control, traffic, voice superframe) P25P1 dibit streams
    (``bench_torch.p25_streams``) of this run's talkgroup and radio."""
    import bench_torch
    return bench_torch.p25_streams(total_dibits, base_hz, traffic_index,
                                   group=GROUP, source=SOURCE, **kw)


def _p25p2_cycle():
    """One call cycle of P25P2 dibits of this run's key, talkgroup and
    radio (``bench_torch.p25p2_cycle``): scrambled PTT + VOICE_4, then
    END_PTT, so that each cycle's voice ends as an AudioSegment."""
    import bench_torch
    return bench_torch.p25p2_cycle(P25P2_KEY, GROUP, SOURCE)


def _lsm_tsbks():
    """A P25P1 control stream of TSBKs (``bench_torch.lsm_tsbks``)."""
    import bench_torch
    return bench_torch.lsm_tsbks()


def _tiled_streams(cycle, modulate, sps: float, slots: int, n_ch: int,
                   seed: int):
    """(slots, n_ch) complex64 on the card: a dibit cycle, tiled and
    modulated once (sps samples a symbol), read from a random phase per
    slot (``bench_torch._tiled``'s base and starts)."""
    import torch

    import bench_torch
    base, starts = bench_torch._tiled(cycle, modulate, sps, slots, n_ch,
                                      seed)
    base = torch.as_tensor(base, device="cuda")
    return base[torch.as_tensor(starts, device="cuda")[:, None]
                + torch.arange(n_ch, device="cuda")[None, :]]


def synthesize_chunks(ch, streams, offsets, total_chunks: int,
                      blocks: int = CHUNK_BLOCKS) -> list:
    """int8 (n, 2) wideband chunks of m * blocks samples (m, the
    channelizer's bins) of per-slot channel streams (slots, n_ch),
    synthesized on the card by the port's synthesis bank with filter state
    carried across chunks (each chunk re-synthesizes the previous one's
    last 2T blocks, which equals one-shot synthesis)."""
    import torch

    from sdrtrunk_tpu_torch.dsp.synthesizer import synthesize_bank

    m = ch.channels
    chunk = m * blocks
    k = 2 * chunk // m
    bins = torch.as_tensor([ch.channel_for_frequency(o) for o in offsets],
                           device="cuda")
    pad = 2 * ch.taps_per_channel
    half = m // 2
    tail = torch.zeros((pad, m), dtype=torch.complex64, device="cuda")
    xs = []
    for j in range(total_chunks):
        u = torch.zeros((pad + k, m), dtype=torch.complex64, device="cuda")
        u[:pad] = tail
        u[pad:, bins] = streams[:, j * k:(j + 1) * k].T * 0.5
        tail = u[-pad:].clone()
        xs.append(synthesize_bank(u, ch.hmat)[pad * half: pad * half + chunk])
    peak = max(float(torch.view_as_real(x).abs().max()) for x in xs)
    return [torch.clamp(torch.round(torch.view_as_real(x) * (118.0 / peak)),
                        -127, 127).to(torch.int8).cpu().numpy() for x in xs]


def _source(chunks):
    chunk = len(chunks[0])
    pos = 0

    def read(num):
        nonlocal pos
        j = pos // chunk
        pos += num
        return chunks[j] if j < len(chunks) else None

    return read


# the layer key of each symbol loop's kernel in layer_times' record
_KERNEL_LAYER = {"DQPSKDemodulator": "dqpsk_kernel",
                 "GardnerDQPSKDemodulator": "gardner_kernel"}


def _chain_layers(orch, dec, dstate, rows, r: dict, prefix: str) -> list:
    """(name, fn) of each layer of one decoder chain over the select
    layer's streams r["streams"][rows]: a DQPSK chain's front end (FIR,
    power, AGC), its symbol kernel and its tail (the bank tier's
    compaction, sync and packing, or the per-slot path's ``pack_sym``); an
    analog chain's front at the channel rate (FIR, squelch, FM
    discriminator and de-emphasis, or envelope and DC removal), the
    resampler to 8 kHz and its packing (``pack_audio``, or the per-slot
    casts); an analog-trunking chain's NBFM front and resampler, the
    slicer's front (DC removal and low-pass, or the 9/10 resampler and the
    tone correlators), the bit-timing kernel and its packing
    (``pack_mixed``, or ``pack_sym`` and the casts)."""
    import torch

    from sdrtrunk_tpu_torch.dsp.bit_timing import bit_timing
    from sdrtrunk_tpu_torch.dsp.psk import unpack_symbols
    from sdrtrunk_tpu_torch.runtime.orchestrator import (
        compact_and_correlate, pack_audio, pack_mixed, pack_sym,
        sync_patterns)

    def streams():
        return r["streams"][rows]

    def front():
        (r["leveled"], _), _ = dec._front(streams(), dstate)

    def kernel():
        r["packed"], _ = dec.demod._kernel(r["leveled"], dstate["psk"])

    def tail():
        if orch.bank_mode:
            compact_and_correlate(*unpack_symbols(r["packed"]),
                                  orch._bank_cap,
                                  *sync_patterns(orch.decoder_name))
        else:
            pack_sym(*unpack_symbols(r["packed"]))

    if hasattr(dec, "demod"):
        return [(prefix + "front_end", front),
                (prefix + _KERNEL_LAYER[type(dec.demod).__name__], kernel),
                (prefix + "tail", tail)]

    mixed = hasattr(dec, "slicer")
    analog = dec.nbfm if mixed else dec
    astate = dstate["nbfm"] if mixed else dstate

    def analog_front():
        r["audio"], r["gate"], _, _ = analog._front(streams(), astate)

    def resample():
        r["audio8k"], r["gate8k"] = analog._resample(r["audio"], r["gate"],
                                                     astate["resamp"])

    def casts():
        r["audio8k"].to(torch.float32)
        r["gate8k"].to(torch.int8)

    def pack():
        if orch.bank_mode:
            pack_audio(r["audio8k"], r["gate8k"], orch.audio_format)
        else:
            casts()

    layers = [(prefix + "analog_front", analog_front),
              (prefix + "resample", resample)]
    if not mixed:
        return layers + [(prefix + "pack", pack)]
    demod = getattr(dec, dec.slicer)
    sstate = dstate[dec.slicer]

    def slicer_front():
        r["sliced"] = demod.front(dec._slice(r["audio8k"]), sstate)[0]

    def timing():
        r["bits"], r["valid"], _, _ = bit_timing(
            demod.geometry, r["sliced"], sstate.window,
            sstate.sampling_point, getattr(demod, "invert", False))

    def pack_m():
        if orch.bank_mode:
            pack_mixed(r["audio8k"], r["gate8k"], r["bits"], r["valid"],
                       orch._bank_bit_cap)
        else:
            pack_sym(r["bits"], r["valid"])
            casts()

    return layers + [(prefix + "slicer_front", slicer_front),
                     (prefix + "bit_timing_kernel", timing),
                     (prefix + "pack", pack_m)]


def layer_times(orch, iq8) -> dict:
    """Per-chunk device ms of each layer of the live step, on one chunk,
    from a copy of the running state (CUDA events): ingest + channelize,
    select + mix, then each decoder chain's layers (``_chain_layers``);
    with ``banks``, each bank's under "<bank key>/"."""
    import torch

    from sdrtrunk_tpu_torch.convert import tree_map
    from sdrtrunk_tpu_torch.dsp.channelizer import channelize_core
    from sdrtrunk_tpu_torch.receiver import dynamic_select_mix
    from sdrtrunk_tpu_torch.runtime.orchestrator import ingest

    rx = orch.rx
    state = tree_map(lambda a: a.clone(), orch.state)
    bins, steps = (torch.as_tensor(orch.bins, dtype=torch.long,
                                   device="cuda"),
                   torch.as_tensor(orch.steps, device="cuda"))
    x = torch.as_tensor(iq8, device="cuda")
    r = {}

    def chan():
        xc = torch.view_as_complex(ingest(x).contiguous())
        r["y"] = channelize_core(torch.cat([state["chan"], xc]),
                                 rx.channelizer.hmat)

    def select():
        r["streams"], _ = dynamic_select_mix(
            r["y"], state["rot"], state["mixer_phase"], bins, steps, rx.rot4)

    layers = [("ingest_channelize", chan), ("select_mix", select)]
    if orch.banks is None:
        layers += _chain_layers(orch, rx.decoder, state["dec"],
                                slice(None), r, "")
    else:
        off = 0
        for key, _, n, dec in rx.banks:
            layers += _chain_layers(orch, dec, state[key],
                                    slice(off, off + n), r, f"{key}/")
            off += n
    out = {}
    for name, fn in layers:
        fn()
        out[name] = _cuda_ms(fn, reps=3)
    return out


def device_busy_ms(orch, iq8, chunks: int = 2) -> float:
    """Device busy ms per chunk of the live step, from torch.profiler's
    device-side events (every kernel, copy and memset the step puts on the
    card, the ctypes-launched symbol kernel included) over `chunks` steps
    on one chunk from a copy of the running state; the union of their
    intervals, so nothing is counted twice. The chunk's upload and the
    packed download are not in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdrtrunk_tpu_torch.convert import tree_map

    state = tree_map(lambda a: a.clone(), orch.state)
    x = torch.as_tensor(iq8, device="cuda")
    plan = (torch.as_tensor(orch.bins, dtype=torch.long, device="cuda"),
            torch.as_tensor(orch.steps, device="cuda"))
    orch.step(x, state, *plan)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            _, state = orch.step(x, state, *plan)
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy = end = 0
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6 / chunks


def _host_layer(orch):
    """(object, name) of the live loop's host layer, timed by ``drive``:
    the bank framer's ``frame_chunk`` for a digital bank, ``route_audio``
    for an analog one, ``route_mixed`` for an analog-trunking one, the
    worker process's round trip ``process_chunk`` (its framing and routing
    included) with ``host_process``, and the per-slot processors'
    ``_route_slots`` on the per-slot path and with ``banks``."""
    if orch.bank_host is not None:
        return orch.bank_host, "process_chunk"
    if not orch.bank_mode:
        return orch, "_route_slots"
    return orch.bank_proc, ("route_mixed" if orch.bank_mixed else
                            "route_audio" if orch.bank_analog else
                            "frame_chunk")


def drive(orch, expect: dict, chunks: int, warmup: int,
          before_timed=None) -> dict:
    """Run the live loop for `chunks` chunks (the first `warmup` untimed)
    with every kernel's launch count set to 0 just before and read just
    after. Checks that every live-step output lay on the card and that
    each kernel launched as `expect` says ({kernels-line entry: launches a
    chunk}, as the wrappers counted them by timing gain or window length;
    an entry not named, none; the channelizer once a chunk unless named). ``before_timed(orch)``, when given, runs
    between the warm-up and the timed chunks. The host layer
    (``_host_layer``) is timed. Returns timing and counts."""
    import torch

    devices = set()
    step = orch.step

    def spy_step(*args):
        out, st = step(*args)
        devices.update(v.device.type for v in out.values())
        return out, st
    orch.step = spy_step
    host = {"s": 0.0}
    host_obj, host_layer = _host_layer(orch)
    host_fn = getattr(host_obj, host_layer)

    def timed_host(*args):
        f0 = time.perf_counter()
        try:
            return host_fn(*args)
        finally:
            host["s"] += time.perf_counter() - f0
    setattr(host_obj, host_layer, timed_host)

    _reset_launches()                           # count the main path only
    orch.run(max_chunks=warmup)
    torch.cuda.synchronize()
    if before_timed is not None:
        before_timed(orch)
    host["s"] = 0.0
    t0 = time.perf_counter()
    metrics = orch.run(max_chunks=chunks - warmup)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _read_launches()

    timed = orch.chunk_samples * (chunks - warmup)
    expect = {"channelize": 1, **expect}
    want = {entry: chunks * expect.get(entry, 0) for entry in _ENTRY_KEYS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} for {chunks} "
                             f"chunks (expected {want})")
    if devices != {"cuda"}:
        raise AssertionError(f"live step outputs on {devices}")
    return {"metrics": metrics, "launches": launches,
            "wall_ms_per_chunk": elapsed * 1e3 / (chunks - warmup),
            "msps": timed / elapsed / 1e6,
            "realtime_factor": timed / elapsed / FS,
            "host_layer": host_layer,
            "host_ms_per_chunk": host["s"] * 1e3 / (chunks - warmup)}


def _loop_record(orch, iq8, run) -> dict:
    """What every live loop prints: its realtime factor and MS/s, wall and
    host ms a chunk of the timed run, its device layers (on the chunk
    iq8), and the device's busy ms a chunk and idle share of the wall
    time."""
    busy = device_busy_ms(orch, iq8)
    return {"msps": run["msps"], "realtime_factor": run["realtime_factor"],
            "wall_ms_per_chunk": run["wall_ms_per_chunk"],
            "host_layer": run["host_layer"],
            "host_ms_per_chunk": run["host_ms_per_chunk"],
            "device_ms_per_chunk": layer_times(orch, iq8),
            "device_busy_ms_per_chunk": busy,
            "device_idle_share": 1.0 - busy / run["wall_ms_per_chunk"],
            "kernel_launches": run["launches"]}


def _coverage(orch, slot_hz):
    """Frames decoded on each of the slots at slot_hz."""
    import numpy as np
    by_freq = {s["frequency_hz"]: s for s in orch.channel_status()}
    return np.array([by_freq[f]["frames"] for f in slot_hz])


# phase 5's synthesized chunks and record, which the worker phase reuses
_C4FM: dict = {}


def _c4fm_scene():
    """Phase 5's scene: the channelizer, the 1023 slot offsets, the
    wideband chunks (made once, kept for the worker phase), the
    synthesis seconds."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    chunk = M * CHUNK_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    assert ch.channels == M
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    if "chunks" in _C4FM:
        return ch, offsets, _C4FM["chunks"], 0.0
    t0 = time.perf_counter()
    rate = ch.channel_sample_rate
    n_ch = (WARMUP + TIMED + 1) * (2 * chunk // M)
    control, traffic, superframe = _p25_streams(
        int(n_ch / rate * 4800) + 64, CENTER_HZ + offsets[0])
    streams = _tiled_streams(superframe, lambda d: c4fm_modulate(d, rate),
                             rate / 4800.0, SLOTS, n_ch, seed=0)
    for row, dib in ((0, control), (TRAFFIC_INDEX, traffic)):
        streams[row] = torch.as_tensor(
            c4fm_modulate(dib, rate)[:n_ch].astype(np.complex64),
            device="cuda")
    _C4FM["chunks"] = synthesize_chunks(ch, streams, offsets, WARMUP + TIMED)
    return ch, offsets, _C4FM["chunks"], time.perf_counter() - t0


def _c4fm_orchestrator(chunks, offsets, traffic_index: int = TRAFFIC_INDEX,
                       **kw):
    """Phase 5's orchestrator: the C4FM bank of a slot per offset (1023),
    every voice slot activated, the granted channel's slot left free.
    Returns (orch, the traffic channel's Hz, the voice slots' Hz)."""
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    kw.setdefault("chunk_samples", M * CHUNK_BLOCKS)
    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=len(offsets), decoder="c4fm",
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        bank_mode=True, device="cuda", **kw)
    traffic_hz = CENTER_HZ + offsets[traffic_index]
    voice_hz = [CENTER_HZ + o for i, o in enumerate(offsets)
                if i not in (0, traffic_index)]
    for f in voice_hz:
        orch._activate(f, IdentifierCollection())
    if sum(s.active for s in orch.slots) != len(offsets) - 1:
        raise AssertionError("voice slots did not all activate")
    return orch, traffic_hz, voice_hz


def _c4fm_checks(orch, traffic_hz, voice_hz):
    """Phase 5's coverage: the grant followed, frames on the granted slot
    and on >= 99% of the voice slots, an AudioSegment. The granted slot is
    looked up within 1 Hz (``_granted``)."""
    status = {s["frequency_hz"]: s for s in orch.channel_status()}
    slot = _granted(orch, traffic_hz)
    traffic = None if slot is None else status[slot.frequency_hz]
    voice_frames = _coverage(orch, voice_hz)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    found = {
        "frames": int(sum(s["frames"] for s in status.values())),
        "voice_slots_with_frames": int((voice_frames > 0).sum()),
        "voice_slots": len(voice_hz),
        "traffic_frames": None if traffic is None else traffic["frames"],
        "events": len(orch.events), "audio_segments": len(segs),
        "skipped_grants": len(orch.skipped_grants)}

    def check():
        if traffic is None:
            raise AssertionError("the grant did not activate the traffic "
                                 "slot")
        if not traffic["frames"]:
            raise AssertionError("no frames decoded on the granted slot")
        if (voice_frames > 0).mean() < 0.99:
            raise AssertionError(f"frames on only {(voice_frames > 0).sum()} "
                                 f"of {len(voice_hz)} voice slots")
        if not segs:
            raise AssertionError("no AudioSegment")
    return found, check


def run_c4fm(card: str) -> dict:
    ch, offsets, chunks, synth_s = _c4fm_scene()
    orch, traffic_hz, voice_hz = _c4fm_orchestrator(chunks, offsets)
    run = drive(orch, {"dqpsk": 1}, WARMUP + TIMED, WARMUP)
    found, check = _c4fm_checks(orch, traffic_hz, voice_hz)
    result = {
        "card": card, "decoder": "c4fm", "slots": SLOTS,
        "wideband_msps": FS / 1e6, "chunk_samples": orch.chunk_samples,
        "timed_chunks": TIMED, **found,
        "active_channels": run["metrics"].get("active_channels"),
        **_loop_record(orch, chunks[-1], run),
        "synthesis_s": synth_s,
    }
    print("[live c4fm] " + json.dumps(result), flush=True)
    _C4FM["result"] = result
    check()
    return result


# phase 5's C4FM bank on 25 kHz channels: 512 bins of 25 kHz at 12.8 MS/s,
# a 50 kHz channel rate (DQPSK at W = 20); chunks of 512 x 5120 (0.205 s,
# T = 10240), 2 + 3; the call on the granted channel starts at 0.6 s
M_25K, SLOTS_25K = 512, 511
WARMUP_25K, TIMED_25K = 2, 3
TRAFFIC_INDEX_25K = 300
TRAFFIC_START_25K = 0.6


def run_c4fm_25k(card: str) -> dict:
    """Orchestrator(decoder="c4fm", channel_bandwidth=25000.0) at 12.8
    MS/s: 511 slots of 25 kHz channels (a P25 control channel whose
    IDEN_UP announces 25 kHz spacing, granting a free slot; 509 voice
    slots), 2 + 3 chunks; phase 5's checks (the grant followed, frames on
    the granted slot and on >= 99% of the voice slots, an AudioSegment),
    one DQPSK launch a chunk at W = 20."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    t0 = time.perf_counter()
    ch = Channelizer.design(FS, 25000.0, device="cuda")
    assert ch.channels == M_25K
    rate = ch.channel_sample_rate
    offsets = [(i - M_25K // 2 + 1) * 25000.0 for i in range(SLOTS_25K)]
    chunks_total = WARMUP_25K + TIMED_25K
    n_ch = (chunks_total + 1) * 2 * CHUNK_BLOCKS
    control, traffic, superframe = _p25_streams(
        int(n_ch / rate * 4800) + 64, CENTER_HZ + offsets[0],
        traffic_index=TRAFFIC_INDEX_25K, spacing_hz=25000.0,
        traffic_start_s=TRAFFIC_START_25K)
    streams = _tiled_streams(superframe, lambda d: c4fm_modulate(d, rate),
                             rate / 4800.0, SLOTS_25K, n_ch, seed=0)
    for row, dib in ((0, control), (TRAFFIC_INDEX_25K, traffic)):
        streams[row] = torch.as_tensor(
            c4fm_modulate(dib, rate)[:n_ch].astype(np.complex64),
            device="cuda")
    chunks = synthesize_chunks(ch, streams, offsets, chunks_total)
    synth_s = time.perf_counter() - t0
    orch, traffic_hz, voice_hz = _c4fm_orchestrator(
        chunks, offsets, traffic_index=TRAFFIC_INDEX_25K,
        channel_bandwidth=25000.0, chunk_samples=M_25K * CHUNK_BLOCKS)
    if orch.rx.decoder.demod.window_len != 20:
        raise AssertionError(f"W = {orch.rx.decoder.demod.window_len} at "
                             f"{orch.rx.channelizer.channel_sample_rate} Hz")
    run = drive(orch, {"dqpsk_w20": 1}, chunks_total, WARMUP_25K)
    found, check = _c4fm_checks(orch, traffic_hz, voice_hz)
    result = {
        "card": card, "decoder": "c4fm", "channel_bandwidth": 25000.0,
        "slots": SLOTS_25K, "wideband_msps": FS / 1e6,
        "chunk_samples": orch.chunk_samples, "timed_chunks": TIMED_25K,
        **found, "active_channels": run["metrics"].get("active_channels"),
        **_loop_record(orch, chunks[-1], run), "synthesis_s": synth_s,
    }
    print("[live c4fm_25k] " + json.dumps(result), flush=True)
    check()
    return result


def run_p25p2(card: str) -> dict:
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.signal.generators import lsm_modulate
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    chunk = M * CHUNK_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    t0 = time.perf_counter()
    rate = ch.channel_sample_rate
    n_ch = (WARMUP + TIMED + 1) * (2 * chunk // M)
    streams = _tiled_streams(
        _p25p2_cycle(),
        lambda d: lsm_modulate(d, sample_rate=rate, symbol_rate=6000.0),
        rate / 6000.0, SLOTS, n_ch, seed=0)
    chunks = synthesize_chunks(ch, streams, offsets, WARMUP + TIMED)
    synth_s = time.perf_counter() - t0

    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=SLOTS, decoder="p25p2", chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        bank_mode=True, device="cuda")
    voice_hz = [CENTER_HZ + o for o in offsets[1:]]
    for f in voice_hz:
        orch._activate(f, IdentifierCollection())
    if sum(s.active for s in orch.slots) != SLOTS:
        raise AssertionError("voice slots did not all activate")
    # traffic channels carry the system's scramble parameters (a control
    # channel's preload in production; set directly, as bench.py does)
    for s in range(SLOTS):
        orch.bank_proc.framer.set_scramble_parameters(s, *P25P2_KEY)
        orch.bank_proc.states[s].scramble_key = P25P2_KEY

    run = drive(orch, {"gardner_p25p2": 1}, WARMUP + TIMED, WARMUP)
    voice_frames = _coverage(orch, voice_hz)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    result = {
        "card": card, "decoder": "p25p2", "slots": SLOTS,
        "timeslots": 2 * SLOTS, "wideband_msps": FS / 1e6,
        "chunk_samples": chunk, "timed_chunks": TIMED,
        "fragments": int(sum(s["frames"] for s in orch.channel_status())),
        "voice_slots_with_fragments": int((voice_frames > 0).sum()),
        "voice_slots": len(voice_hz), "audio_segments": len(segs),
        "active_channels": run["metrics"].get("active_channels"),
        **_loop_record(orch, chunks[-1], run),
        "synthesis_s": synth_s,
    }
    print("[live p25p2] " + json.dumps(result), flush=True)
    if (voice_frames > 0).mean() < 0.99:
        raise AssertionError(f"fragments on only {(voice_frames > 0).sum()} "
                             f"of {len(voice_hz)} voice slots")
    if not segs:
        raise AssertionError("no AudioSegment")
    return result


def run_lsm(card: str) -> dict:
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.signal.generators import lsm_modulate
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    chunk = M * CHUNK_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    # 64 slots spread over the band, 16 bins apart
    offsets = [(16 * i - M // 2 + 8) * 12500.0 for i in range(LSM_SLOTS)]
    rate = ch.channel_sample_rate
    n_ch = (LSM_CHUNKS + 1) * (2 * chunk // M)
    streams = _tiled_streams(
        _lsm_tsbks(), lambda d: lsm_modulate(d, sample_rate=rate),
        rate / 4800.0, LSM_SLOTS, n_ch, seed=3)
    chunks = synthesize_chunks(ch, streams, offsets, LSM_CHUNKS)
    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=LSM_SLOTS, decoder="lsm", chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        bank_mode=True, device="cuda")
    slot_hz = [CENTER_HZ + o for o in offsets]
    for f in slot_hz[1:]:
        orch._activate(f, IdentifierCollection())
    run = drive(orch, {"gardner_lsm": 1}, LSM_CHUNKS, 1)
    frames = _coverage(orch, slot_hz)
    result = {"card": card, "decoder": "lsm", "slots": LSM_SLOTS,
              "chunks": LSM_CHUNKS, "frames": int(frames.sum()),
              "control_frames": int(frames[0]),
              "slots_with_frames": int((frames > 0).sum()),
              **_loop_record(orch, chunks[-1], run)}
    print("[live lsm] " + json.dumps(result), flush=True)
    if not frames[0] or (frames > 0).mean() < 0.99:
        raise AssertionError(f"LSM frames on {(frames > 0).sum()} of "
                             f"{LSM_SLOTS} slots (control {frames[0]})")
    return result



def _dmr_streams(total_dibits: int):
    """(control, traffic, call cycle) DMR dibit streams of this run's
    talkgroup and radio, the control granting channel TRAFFIC_INDEX
    (``bench_torch.dmr_streams``)."""
    import bench_torch
    return bench_torch.dmr_streams(total_dibits, TRAFFIC_INDEX, GROUP,
                                   SOURCE)


def run_dmr(card: str) -> dict:
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    chunk = M * CHUNK_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    t0 = time.perf_counter()
    rate = ch.channel_sample_rate
    n_ch = (WARMUP + TIMED + 1) * (2 * chunk // M)
    control, traffic, call = _dmr_streams(int(n_ch / rate * 4800) + 64)
    streams = _tiled_streams(call, lambda d: c4fm_modulate(d, rate),
                             rate / 4800.0, SLOTS, n_ch, seed=0)
    for row, dib in ((0, control), (TRAFFIC_INDEX, traffic)):
        streams[row] = torch.as_tensor(
            c4fm_modulate(dib, rate)[:n_ch].astype(np.complex64),
            device="cuda")
    chunks = synthesize_chunks(ch, streams, offsets, WARMUP + TIMED)
    synth_s = time.perf_counter() - t0

    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=SLOTS, decoder="dmr", chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        bank_mode=True, device="cuda")
    # the band plan maps the grant's channel n to control + n * 12.5 kHz
    orch.traffic.update_band(FrequencyBand(
        identifier=0, base_frequency_hz=CENTER_HZ + offsets[0],
        channel_spacing_hz=12500.0))
    traffic_hz = CENTER_HZ + offsets[TRAFFIC_INDEX]
    voice_hz = [CENTER_HZ + o for i, o in enumerate(offsets)
                if i not in (0, TRAFFIC_INDEX)]
    for f in voice_hz:
        orch._activate(f, IdentifierCollection())
    if sum(s.active for s in orch.slots) != SLOTS - 1:
        raise AssertionError("voice slots did not all activate")

    run = drive(orch, {"dqpsk_dmr": 1}, WARMUP + TIMED, WARMUP)
    voice_frames = _coverage(orch, voice_hz)
    status = {s["frequency_hz"]: s for s in orch.channel_status()}
    granted = status.get(traffic_hz)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    result = {
        "card": card, "decoder": "dmr", "slots": SLOTS,
        "timeslots": 2 * SLOTS, "wideband_msps": FS / 1e6,
        "chunk_samples": chunk, "bank_cap": orch._bank_cap,
        "timed_chunks": TIMED,
        "frames": int(sum(s["frames"] for s in status.values())),
        "voice_slots_with_frames": int((voice_frames > 0).sum()),
        "voice_slots": len(voice_hz),
        "traffic_frames": None if granted is None else granted["frames"],
        "events": len(orch.events), "audio_segments": len(segs),
        "skipped_grants": len(orch.skipped_grants),
        "active_channels": run["metrics"].get("active_channels"),
        **_loop_record(orch, chunks[-1], run),
        "synthesis_s": synth_s,
    }
    print("[live dmr] " + json.dumps(result), flush=True)
    if granted is None or not any(s.active and s.frequency_hz == traffic_hz
                                  for s in orch.slots):
        raise AssertionError("the grant did not activate the traffic slot")
    if not granted["frames"]:
        raise AssertionError("no frames decoded on the granted slot")
    if (voice_frames > 0).mean() < 0.99:
        raise AssertionError(f"frames on only {(voice_frames > 0).sum()} of "
                             f"{len(voice_hz)} voice slots")
    if not segs:
        raise AssertionError("no AudioSegment")
    return result


def _dominant_hz(samples) -> float:
    """The strongest frequency of 8 kHz audio, its first 0.1 s left out
    (the squelch and de-emphasis settling)."""
    import numpy as np
    x = np.asarray(samples[800:], np.float64)
    spec = np.abs(np.fft.rfft(x - x.mean()))
    return float(np.fft.rfftfreq(len(x), 1 / 8000.0)[int(np.argmax(spec))])


def _analog_loop(card: str, decoder: str, streams, offsets, warmup: int,
                 chunks_total: int, tone_hz: float, sampled) -> dict:
    """An analog bank live loop: every slot activated, `chunks_total`
    chunks of M x ANALOG_BLOCKS (the first `warmup` untimed), no symbol
    kernel launched. Returns the loop's record with, per slot, whether it
    had an AudioSegment (open, or completed and drained) longer than 1 s,
    and the dominant frequency of the open segment of each sampled slot."""
    import numpy as np

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    chunk = M * ANALOG_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    t0 = time.perf_counter()
    chunks = synthesize_chunks(ch, streams, offsets, chunks_total,
                               ANALOG_BLOCKS)
    synth_s = time.perf_counter() - t0
    slots = len(offsets)
    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=slots, decoder=decoder, chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        bank_mode=True, device="cuda")
    for o in offsets[1:]:
        orch._activate(CENTER_HZ + o, IdentifierCollection())
    if sum(s.active for s in orch.slots) != slots:
        raise AssertionError("slots did not all activate")
    long_done = set()
    drain = orch.bank_proc.drain_audio

    def drain_long(slot):
        segs = drain(slot)
        if any(s.duration > 1.0 for s in segs):
            long_done.add(slot)
        return segs
    orch.bank_proc.drain_audio = drain_long

    run = drive(orch, {}, chunks_total, warmup)
    modules = orch.bank_proc.modules
    long_audio = np.array([
        s in long_done or (modules[s].segment is not None
                           and modules[s].segment.duration > 1.0)
        for s in range(slots)])
    tones = [_dominant_hz(modules[s].segment.samples)
             if modules[s].segment is not None else 0.0 for s in sampled]
    result = {
        "card": card, "decoder": decoder, "slots": slots,
        "wideband_msps": FS / 1e6, "chunk_samples": chunk,
        "audio_samples_per_chunk": orch._bank_ka,
        "audio_format": orch.audio_format, "chunks": chunks_total,
        "timed_chunks": chunks_total - warmup,
        "slots_with_audio_over_1s": int(long_audio.sum()),
        "audio_segments": len(orch.audio_segments),
        "sampled_slots": list(map(int, sampled)), "dominant_hz": tones,
        **_loop_record(orch, chunks[-1], run),
        "synthesis_s": synth_s,
    }
    print(f"[live {decoder}] " + json.dumps(result), flush=True)
    if long_audio.mean() < 0.99:
        raise AssertionError(f"{decoder}: audio over 1 s on only "
                             f"{long_audio.sum()} of {slots} slots")
    off = [f for f in tones if abs(f - tone_hz) > 50.0]
    if off:
        raise AssertionError(f"{decoder}: dominant frequencies {tones}, "
                             f"expected {tone_hz} +/- 50 Hz")
    return result


def run_nbfm(card: str) -> dict:
    """bench.py's NBFM bank: 1023 slots, each NBFM voice (a 700 Hz tone
    at 0.7, modulated at the 25 kHz channel rate) from a random start."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.signal.generators import nbfm_modulate

    total = NBFM_WARMUP + NBFM_TIMED
    rate = 25000.0
    n_ch = (total + 1) * (2 * ANALOG_BLOCKS)
    rng = np.random.default_rng(0)
    audio = 0.7 * np.sin(2 * np.pi * NBFM_TONE_HZ
                         * np.arange(int((n_ch + 25000) / rate * 8000.0)
                                     + 8000) / 8000.0)
    base = torch.as_tensor(nbfm_modulate(audio, 8000.0, rate)
                           .astype(np.complex64), device="cuda")
    starts = torch.as_tensor(rng.integers(0, 25000, SLOTS), device="cuda")
    streams = base[starts[:, None]
                   + torch.arange(n_ch, device="cuda")[None, :]]
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    sampled = np.sort(rng.choice(SLOTS, 16, replace=False))
    return _analog_loop(card, "nbfm", streams, offsets, NBFM_WARMUP, total,
                        NBFM_TONE_HZ, sampled)


def run_am(card: str) -> dict:
    """64 slots 16 bins apart, each a carrier at a random phase with a 1
    kHz tone at 50% AM depth (the tone's phase random per slot)."""
    import numpy as np
    import torch

    rate = 25000.0
    n_ch = (AM_CHUNKS + 1) * (2 * ANALOG_BLOCKS)
    rng = np.random.default_rng(4)
    t = torch.arange(n_ch, device="cuda", dtype=torch.float64) / rate
    tone = torch.as_tensor(rng.uniform(0, 2 * np.pi, AM_SLOTS),
                           device="cuda")[:, None]
    carrier = torch.as_tensor(rng.uniform(0, 2 * np.pi, AM_SLOTS),
                              device="cuda")[:, None]
    env = 1.0 + 0.5 * torch.sin(2 * np.pi * AM_TONE_HZ * t[None, :] + tone)
    streams = torch.polar(env, carrier.expand_as(env)).to(torch.complex64)
    offsets = [(16 * i - M // 2 + 8) * 12500.0 for i in range(AM_SLOTS)]
    return _analog_loop(card, "am", streams, offsets, 1, AM_CHUNKS,
                        AM_TONE_HZ, np.arange(AM_SLOTS))


def _fm_streams(message, rate: float, deviation_hz: float = 3000.0):
    """(slots, n) complex64 on the card: each row of the real message
    (slots, n) frequency-modulated at the channel rate
    (``bench_torch.fm_streams``)."""
    import torch

    import bench_torch
    return torch.as_tensor(bench_torch.fm_streams(
        message.double().cpu().numpy(), rate, deviation_hz), device="cuda")


def _voice(slots: int, n_ch: int, rate: float, rng, amplitude: float):
    """(slots, n_ch) float64 on the card: the voice tone at a random phase
    per slot (``bench_torch.voice``)."""
    import torch

    import bench_torch
    return torch.as_tensor(bench_torch.voice(slots, n_ch, rate, rng,
                                             amplitude), device="cuda")


def _mixed_loop(card: str, decoder: str, streams, offsets, free: set,
                warmup: int, chunks_total: int, **orch_kw):
    """A mixed-bank live loop: `chunks_total` chunks of M x MIXED_BLOCKS
    (the first `warmup` untimed) with every slot but those in `free`
    activated, one bit-timing launch per chunk. Returns (orch, the run's
    record, the slots that had an AudioSegment, open or completed and
    drained, longer than 1 s, the last chunk, the synthesis time)."""
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    chunk = M * MIXED_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    t0 = time.perf_counter()
    chunks = synthesize_chunks(ch, streams, offsets, chunks_total,
                               MIXED_BLOCKS)
    synth_s = time.perf_counter() - t0
    slots = len(offsets)
    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=slots, decoder=decoder, chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        bank_mode=True, device="cuda", **orch_kw)
    for i, o in enumerate(offsets):
        if i and i not in free:
            orch._activate(CENTER_HZ + o, IdentifierCollection())
    if sum(s.active for s in orch.slots) != slots - len(free):
        raise AssertionError("slots did not all activate")
    long_done = set()
    drain = orch.bank_proc.drain_audio

    def drain_long(slot):
        segs = drain(slot)
        if any(s.duration > 1.0 for s in segs):
            long_done.add(slot)
        return segs
    orch.bank_proc.drain_audio = drain_long

    entry = {"ltr": "bit_timing_ltr", "mpt1327": "bit_timing_afsk"}[decoder]
    run = drive(orch, {entry: 1}, chunks_total, warmup)
    for s, proc in enumerate(orch.bank_proc.procs):
        if proc is not None and proc.audio.segment is not None \
                and proc.audio.segment.duration > 1.0:
            long_done.add(s)
    return orch, run, long_done, chunks[-1], synth_s


def run_ltr(card: str) -> dict:
    """1023 slots, each an NBFM carrier with the voice tone (0.5) plus
    sub-audible square FSK (+/-0.35, 300 baud) of LTR CALL words for the
    slot's own talkgroup (home 1-5, group 1-253), from a random start."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.protocol.ltr.messages import (LTRMessageType,
                                                          ltr_encode_word)

    total = LTR_WARMUP + LTR_TIMED
    rate = 25000.0
    n_ch = (total + 1) * (2 * MIXED_BLOCKS)
    rng = np.random.default_rng(0)
    ident = [(s // 253 + 1, s % 253 + 1) for s in range(SLOTS)]
    words = np.stack([ltr_encode_word(0, home, home, group, home)
                      for home, group in ident])           # (slots, 40)
    bits = torch.as_tensor(words, device="cuda")
    start = torch.as_tensor(rng.integers(0, 40 * 84, SLOTS), device="cuda")
    data = 0.35 * _square_fsk(bits, n_ch, rate / 300.0, start)
    streams = _fm_streams(data.double() + _voice(SLOTS, n_ch, rate, rng, 0.5),
                          rate)
    del data
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    orch, run, long_audio, last, synth_s = _mixed_loop(
        card, "ltr", streams, offsets, set(), LTR_WARMUP, total)

    calls = np.zeros(SLOTS, np.int64)
    wrong = 0
    for s, proc in enumerate(orch.bank_proc.procs):
        for m in proc.messages:
            if m.message_type == LTRMessageType.CALL:
                if (m.home, m.group) == ident[s]:
                    calls[s] += 1
                else:
                    wrong += 1
    result = {
        "card": card, "decoder": "ltr", "slots": SLOTS,
        "wideband_msps": FS / 1e6, "chunk_samples": orch.chunk_samples,
        "audio_samples_per_chunk": orch._bank_ka,
        "bit_cap": orch._bank_bit_cap, "chunks": total,
        "timed_chunks": LTR_TIMED,
        "slots_with_own_call_words": int((calls > 0).sum()),
        "call_words": int(calls.sum()), "call_words_of_another_group": wrong,
        "slots_with_audio_over_1s": len(long_audio),
        "audio_segments": len(orch.audio_segments),
        **_loop_record(orch, last, run),
        "synthesis_s": synth_s,
    }
    print("[live ltr] " + json.dumps(result), flush=True)
    if (calls > 0).mean() < 0.99:
        raise AssertionError(f"ltr: CALL words of the slot's own group on "
                             f"only {(calls > 0).sum()} of {SLOTS} slots")
    if len(long_audio) != SLOTS:
        raise AssertionError(f"ltr: audio over 1 s on only "
                             f"{len(long_audio)} of {SLOTS} slots")
    return result


def _mpt_control(n: int, rate: float, rng):
    """n samples at rate of an MPT1327 control channel granting channel
    MPT_TRAFFIC_INDEX (``bench_torch.mpt_control``)."""
    import bench_torch
    return bench_torch.mpt_control(n, rate, rng, MPT_TRAFFIC_INDEX)


def run_mpt1327(card: str) -> dict:
    """1023 slots with a channel map: slot 0 a control channel of AFSK
    codewords (ALH, then GTC for channel MPT_TRAFFIC_INDEX, repeated), the
    granted channel's slot left free for the grant, FM voice on it and on
    the other 1021 slots."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.protocol.mpt1327 import MPT1327MessageType
    from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand

    total = MPT_WARMUP + MPT_TIMED
    rate = 25000.0
    n_ch = (total + 1) * (2 * MIXED_BLOCKS)
    rng = np.random.default_rng(13)
    control = _mpt_control(n_ch, rate, rng)

    streams = _fm_streams(_voice(SLOTS, n_ch, rate, rng, 0.6), rate)
    streams[0] = torch.as_tensor(control[:n_ch].astype(np.complex64),
                                 device="cuda")
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    band = FrequencyBand(identifier=0,
                         base_frequency_hz=CENTER_HZ + offsets[0],
                         channel_spacing_hz=12500.0)
    orch, run, long_audio, last, synth_s = _mixed_loop(
        card, "mpt1327", streams, offsets, {MPT_TRAFFIC_INDEX}, MPT_WARMUP,
        total, channel_map=band)

    types = [m.message_type for m in orch.bank_proc.procs[0].messages]
    gtcs = [m for m in orch.bank_proc.procs[0].messages
            if m.message_type == MPT1327MessageType.GTC]
    traffic_hz = CENTER_HZ + offsets[MPT_TRAFFIC_INDEX]
    granted = next((s for s in orch.slots if s.active and not s.is_control
                    and s.frequency_hz == traffic_hz), None)
    granted_audio = 0.0
    tone_hz = 0.0
    if granted is not None:
        seg = orch.bank_proc.procs[granted.index].audio.segment
        if seg is not None:
            granted_audio = float(seg.duration)
            if len(seg.samples) > 1600:
                tone_hz = _dominant_hz(seg.samples)
    result = {
        "card": card, "decoder": "mpt1327", "slots": SLOTS,
        "wideband_msps": FS / 1e6, "chunk_samples": orch.chunk_samples,
        "audio_samples_per_chunk": orch._bank_ka,
        "bit_cap": orch._bank_bit_cap, "chunks": total,
        "timed_chunks": MPT_TIMED,
        "control_alh": types.count(MPT1327MessageType.ALH),
        "control_gtc": len(gtcs),
        "gtc_channel": gtcs[0].fields["channel"] if gtcs else None,
        "grant_events": len([e for e in orch.events
                             if e.frequency_hz == traffic_hz]),
        "skipped_grants": len(orch.skipped_grants),
        "granted_slot": None if granted is None else granted.index,
        "granted_audio_s": granted_audio, "granted_dominant_hz": tone_hz,
        "slots_with_audio_over_1s": len(long_audio),
        "active_channels": run["metrics"].get("active_channels"),
        **_loop_record(orch, last, run),
        "synthesis_s": synth_s,
    }
    print("[live mpt1327] " + json.dumps(result), flush=True)
    if not result["control_alh"] or not gtcs \
            or gtcs[0].fields["channel"] != MPT_TRAFFIC_INDEX:
        raise AssertionError(f"mpt1327: control slot decoded "
                             f"{result['control_alh']} ALH, {len(gtcs)} GTC")
    if granted is None or not result["grant_events"]:
        raise AssertionError("mpt1327: the grant did not activate the "
                             "traffic slot")
    if granted_audio < 0.4 or abs(tone_hz - VOICE_TONE_HZ) > 50.0:
        raise AssertionError(f"mpt1327: {granted_audio:.2f} s of audio at "
                             f"{tone_hz:.0f} Hz on the granted slot")
    if result["active_channels"] != SLOTS:
        raise AssertionError("mpt1327: not every slot is active after the "
                             "grant")
    return result


# --- the per-slot path, banks= and the worker process ---------------------

def _offset(channel: int) -> float:
    """Baseband offset of channel index `channel` of the 1023-slot grid."""
    return (channel - M // 2 + 1) * 12500.0


def _slot_channels():
    """The per-slot phases' SLOT_COUNT channel offsets
    (``bench_torch._slot_channels``): a control channel, the one it grants
    SLOTS_TRAFFIC_INDEX channels above (its slot left free), and the voice
    channels spread over the middle half of the grid, so that they stay in
    coverage at half the sample rate."""
    import bench_torch
    return [_offset(int(i)) for i in bench_torch._slot_channels()]


def _spread_channels():
    """The multibank's SLOT_COUNT channel offsets
    (``bench_torch._spread_channels``): phase 5's control channel and the
    one it grants, and the others spread over the grid."""
    import bench_torch
    return [_offset(int(i)) for i in bench_torch._spread_channels()]


def _dibit_rows(rows, modulate, n_ch: int):
    """(len(rows), n_ch) complex64 on the card: each dibit stream of rows
    modulated and cut to n_ch samples (``bench_torch.dibit_rows``)."""
    import torch

    import bench_torch
    return torch.as_tensor(bench_torch.dibit_rows(rows, modulate, n_ch),
                           device="cuda")


def _count_valid(orch, slot: int, counted: dict):
    """Wrap the download half so that it counts `slot`'s valid dibits."""
    pull = orch._pull

    def counting_pull(out, now):
        host = pull(out, now)
        counted["dibits"] += int(((host["sym"][slot] >> 2) > 0).sum())
        return host
    orch._pull = counting_pull


def _taps_and_rate_change(orch, voice_slot: int, entry: str, chunk: int,
                          tmp, counted: dict) -> dict:
    """Hold the IQ tap's file (the timed chunks' samples at the capture's
    rate) and the bits tap's (the slot's valid dibits, 4 a byte, padded
    to a whole byte) after the taps were stopped, then send one
    SAMPLE_RATE_CHANGE to FS / 2 and run one chunk of noise on the
    rebuilt receiver, the kernel of kernels-line entry `entry` launched
    once."""
    import wave

    import numpy as np

    from sdrtrunk_tpu_torch.sources.tuner import SourceEvent, SourceEventType

    orch.stop_iq_recording()
    orch.stop_bits_recording(voice_slot)
    with wave.open(str(tmp / "wideband_iq.wav"), "rb") as wf:
        iq_frames, iq_rate = wf.getnframes(), wf.getframerate()
    bits_bytes = (tmp / "voice.bits").stat().st_size
    if iq_frames != TIMED * chunk or iq_rate != int(FS):
        raise AssertionError(f"IQ tap: {iq_frames} samples at {iq_rate}, "
                             f"not {TIMED * chunk} at {int(FS)}")
    if bits_bytes != -(-counted["dibits"] // 4) or not counted["dibits"]:
        raise AssertionError(f"bits tap: {bits_bytes} bytes for "
                             f"{counted['dibits']} valid dibits")
    found = {"iq_tap_samples": iq_frames,
             "iq_tap_ms_per_chunk": counted["iq_tap_s"] * 1e3 / TIMED,
             "bits_tap_dibits": counted["dibits"],
             "bits_tap_bytes": bits_bytes}

    _reset_launches()
    before = orch.samples_processed
    orch.on_source_event(SourceEvent(SourceEventType.SAMPLE_RATE_CHANGE,
                                     value=FS / 2))
    rng = np.random.default_rng(5)
    orch.source = lambda n: rng.integers(-20, 21, (n, 2)).astype(np.int8)
    metrics = orch.run(max_chunks=1)
    launched = _read_launches()
    found.update({
        "rate_change_bins": orch.rx.channelizer.channels,
        "rate_change_chunk_samples": orch.chunk_samples,
        "rate_change_active_channels": metrics.get("active_channels"),
        "rate_change_launches": launched})
    if orch.rx.channelizer.channels != M // 2 \
            or orch.samples_processed - before != orch.chunk_samples \
            or launched != {e: int(e in (entry, "channelize"))
                            for e in _ENTRY_KEYS} \
            or not orch.slots[0].active \
            or orch.rx.channelizer.hmat.device.type != "cuda":
        raise AssertionError(f"after the sample-rate change: {found}")
    return found


def _slots_loop(card: str, decoder: str, streams, offsets, entry: str,
                prepare=None) -> tuple:
    """The per-slot live loop at 12.8 MS/s over SLOT_COUNT slots (the
    most bank_mode=None keeps off the bank tier): WARMUP + TIMED chunks of
    M x CHUNK_BLOCKS, every voice slot activated, the granted channel's
    slot left free, the kernel of kernels-line entry `entry` launched
    once a chunk. An IQ tap and a bits tap on the first voice slot run
    through the timed chunks; then the sample rate halves
    (``_taps_and_rate_change``). Returns (orch, record, the voice slots'
    Hz)."""
    import tempfile
    from pathlib import Path

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    chunk = M * CHUNK_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    t0 = time.perf_counter()
    chunks = synthesize_chunks(ch, streams, offsets, WARMUP + TIMED)
    synth_s = time.perf_counter() - t0
    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        slots=SLOT_COUNT, decoder=decoder,
                        chunk_samples=chunk, idle_teardown_seconds=1e9,
                        ppm_correction=False, device="cuda")
    if orch.bank_mode:
        raise AssertionError("bank_mode=None took the bank tier")
    voice_hz = [CENTER_HZ + o for o in offsets[2:]]
    for f in voice_hz:
        orch._activate(f, IdentifierCollection())
    if sum(s.active for s in orch.slots) != SLOT_COUNT - 1:
        raise AssertionError("voice slots did not all activate")
    if prepare is not None:
        prepare(orch)
    voice_slot = next(s.index for s in orch.slots
                      if s.frequency_hz == voice_hz[0])
    counted = {"dibits": 0, "iq_tap_s": 0.0}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def start_taps(o):
            o.start_iq_recording(tmp / "wideband_iq.wav")
            o.start_bits_recording(voice_slot, tmp / "voice.bits")
            _count_valid(o, voice_slot, counted)
            write = o._iq_writer.write

            def timed_write(iq):            # the IQ tap's main-thread cost
                t0 = time.perf_counter()
                write(iq)
                counted["iq_tap_s"] += time.perf_counter() - t0
            o._iq_writer.write = timed_write

        run = drive(orch, {entry: 1}, WARMUP + TIMED, WARMUP,
                    before_timed=start_taps)
        record = _loop_record(orch, chunks[-1], run)
        taps = _taps_and_rate_change(orch, voice_slot, entry, chunk, tmp,
                                     counted)
    return orch, {"card": card, "decoder": decoder, "slots": SLOT_COUNT,
                  "bank_mode": orch.bank_mode, "wideband_msps": FS / 1e6,
                  "chunk_samples": chunk, "timed_chunks": TIMED,
                  "active_channels": run["metrics"].get("active_channels"),
                  **record, **taps, "synthesis_s": synth_s}, voice_hz


def _granted(orch, hz: float, kind: str | None = None):
    """The active traffic slot tuned to hz (a grant's frequency is the
    band plan's sum, which may differ from hz in the last bit), or
    None."""
    return next((s for s in orch.slots if s.active and not s.is_control
                 and abs(s.frequency_hz - hz) < 1.0
                 and kind in (None, s.kind)), None)


def _slot_frames(orch, hz) -> list:
    by_freq = {s.frequency_hz: s for s in orch.slots}
    return [by_freq[f].processor.frame_count for f in hz]


def run_slots(card: str) -> dict:
    """The per-slot C4FM path: a control channel granting a traffic
    channel whose slot is left free, and 29 voice slots of LDU1 / LDU2 /
    TDULC cycles at random phases."""
    import numpy as np

    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    rate = 25000.0
    n_ch = (WARMUP + TIMED + 1) * (2 * CHUNK_BLOCKS)
    offsets = _slot_channels()
    control, traffic, superframe = _p25_streams(
        int(n_ch / rate * 4800) + 64, CENTER_HZ + offsets[0],
        SLOTS_TRAFFIC_INDEX)
    streams = _tiled_streams(superframe, lambda d: c4fm_modulate(d, rate),
                             rate / 4800.0, SLOT_COUNT, n_ch, seed=0)
    streams[:2] = _dibit_rows((control, traffic),
                              lambda d: c4fm_modulate(d, rate), n_ch)
    orch, result, voice_hz = _slots_loop(card, "c4fm", streams, offsets,
                                         "dqpsk")
    granted = _granted(orch, CENTER_HZ + offsets[1])
    voice = np.array(_slot_frames(orch, voice_hz))
    segs = [s for s in orch.audio_segments if s.duration > 0]
    result.update({
        "traffic_frames": None if granted is None
        else granted.processor.frame_count,
        "voice_slots_with_frames": int((voice > 0).sum()),
        "voice_slots": len(voice_hz), "events": len(orch.events),
        "audio_segments": len(segs),
        "skipped_grants": len(orch.skipped_grants)})
    print("[live slots] " + json.dumps(result), flush=True)
    if granted is None or not granted.processor.frame_count:
        raise AssertionError("slots: the grant was not followed, or no "
                             "frames on the granted slot")
    if not (voice > 0).all():
        raise AssertionError(f"slots: frames on only {(voice > 0).sum()} "
                             f"of {len(voice_hz)} voice slots")
    if not segs:
        raise AssertionError("slots: no AudioSegment")
    return result


def _p25p2_control(total_dibits: int, base_hz: float):
    """A P25P2 control channel teaching this run's key and granting
    channel SLOTS_TRAFFIC_INDEX of the band at base_hz to GROUP
    (``bench_torch.p25p2_control``)."""
    import bench_torch
    return bench_torch.p25p2_control(total_dibits, base_hz,
                                     SLOTS_TRAFFIC_INDEX, P25P2_KEY, GROUP,
                                     SOURCE)


def run_slots_p25p2(card: str) -> dict:
    """The per-slot P25 Phase 2 path: the control channel's network status
    teaches the scramble key, its grant activates the free slot with the
    key handed over, and 29 voice slots of scrambled PTT + VOICE_4 cycles
    (their key set on activation, as phase 6 sets it)."""
    import numpy as np

    from sdrtrunk_tpu_torch.signal.generators import lsm_modulate

    rate = 25000.0
    n_ch = (WARMUP + TIMED + 1) * (2 * CHUNK_BLOCKS)
    offsets = _slot_channels()
    total = int(n_ch / rate * 6000) + 64
    cycle = _p25p2_cycle()
    rng = np.random.default_rng(43)
    traffic = np.concatenate([rng.integers(0, 4, int(1.3 * 6000))
                              .astype(np.uint8)]
                             + [cycle] * (total // len(cycle) + 1))
    modulate = lambda d: lsm_modulate(d, sample_rate=rate,  # noqa: E731
                                      symbol_rate=6000.0)
    streams = _tiled_streams(cycle, modulate, rate / 6000.0, SLOT_COUNT,
                             n_ch, seed=0)
    streams[:2] = _dibit_rows(
        (_p25p2_control(total, CENTER_HZ + offsets[0]), traffic),
        modulate, n_ch)

    def set_voice_keys(orch):
        for s in orch.slots:
            if s.active and not s.is_control:
                s.processor.framer.set_scramble_parameters(*P25P2_KEY)
                s.processor.state.scramble_key = P25P2_KEY

    orch, result, voice_hz = _slots_loop(card, "p25p2", streams, offsets,
                                         "gardner_p25p2",
                                         prepare=set_voice_keys)
    control = next(s for s in orch.slots if s.is_control)
    granted = _granted(orch, CENTER_HZ + offsets[1])
    voice = np.array(_slot_frames(orch, voice_hz))
    segs = [s for s in orch.audio_segments if s.duration > 0]
    result.update({
        "control_key": None if control.processor.state.scramble_key is None
        else [hex(v) for v in control.processor.state.scramble_key],
        "granted_key_handed_over": granted is not None
        and granted.processor.state.scramble_key == P25P2_KEY,
        "traffic_fragments": None if granted is None
        else granted.processor.frame_count,
        "voice_slots_with_fragments": int((voice > 0).sum()),
        "voice_slots": len(voice_hz), "audio_segments": len(segs)})
    print("[live slots_p25p2] " + json.dumps(result), flush=True)
    if control.processor.state.scramble_key != P25P2_KEY:
        raise AssertionError("slots_p25p2: the control slot did not learn "
                             "the scramble key")
    if not result["granted_key_handed_over"] \
            or not granted.processor.frame_count:
        raise AssertionError("slots_p25p2: the granted slot did not get the "
                             "learned key, or decoded no fragment")
    if not (voice > 0).all():
        raise AssertionError(f"slots_p25p2: fragments on only "
                             f"{(voice > 0).sum()} of {len(voice_hz)} voice "
                             "slots")
    if not segs:
        raise AssertionError("slots_p25p2: no AudioSegment")
    return result


def run_multibank(card: str) -> dict:
    """banks=[("c4fm", 11), ("dmr", 10), ("ltr", 10)] behind one
    channelizer: a P25 control channel granting a traffic channel (a c4fm
    slot left free) and 9 C4FM voice slots; 10 DMR voice slots of the call
    cycle; 10 LTR carriers, each a voice tone plus CALL words of its own
    group. Chunks of M x MIXED_BLOCKS, 2 + 4."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.protocol.ltr.messages import ltr_encode_word
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    n_c4fm, n_dmr, n_ltr = (n for _, n in MULTIBANK)
    total = MB_WARMUP + MB_TIMED
    rate = 25000.0
    n_ch = (total + 1) * (2 * MIXED_BLOCKS)
    offsets = _spread_channels()
    t0 = time.perf_counter()
    control, traffic, superframe = _p25_streams(
        int(n_ch / rate * 4800) + 64, CENTER_HZ + offsets[0])
    mod = lambda d: c4fm_modulate(d, rate)  # noqa: E731
    call = _dmr_streams(int(n_ch / rate * 4800) + 64)[2]
    rng = np.random.default_rng(17)
    ident = [(k % 5 + 1, 10 * k + 3) for k in range(n_ltr)]
    words = torch.as_tensor(np.stack([ltr_encode_word(0, h, h, g, h)
                                      for h, g in ident]), device="cuda")
    start = torch.as_tensor(rng.integers(0, 40 * 84, n_ltr), device="cuda")
    data = 0.35 * _square_fsk(words, n_ch, rate / 300.0, start)
    streams = torch.cat([
        _dibit_rows((control, traffic), mod, n_ch),
        _tiled_streams(superframe, mod, rate / 4800.0, n_c4fm - 2, n_ch, 0),
        _tiled_streams(call, mod, rate / 4800.0, n_dmr, n_ch, 1),
        _fm_streams(data.double() + _voice(n_ltr, n_ch, rate, rng, 0.5),
                    rate)])
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    chunks = synthesize_chunks(ch, streams, offsets, total, MIXED_BLOCKS)
    synth_s = time.perf_counter() - t0

    orch = Orchestrator(_source(chunks), FS, CENTER_HZ, [offsets[0]],
                        banks=MULTIBANK, chunk_samples=M * MIXED_BLOCKS,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        device="cuda")
    hz = [CENTER_HZ + o for o in offsets]
    kinds = (["c4fm"] * (n_c4fm - 2) + ["dmr"] * n_dmr + ["ltr"] * n_ltr)
    for f, kind in zip(hz[2:], kinds):
        orch._activate(f, IdentifierCollection(), kind=kind)
    if sum(s.active for s in orch.slots) != SLOT_COUNT - 1:
        raise AssertionError("multibank: slots did not all activate")
    long_audio = set()
    for s in orch.slots:
        if s.kind == "ltr":
            drain = s.processor.drain_audio

            def drain_long(drain=drain, index=s.index):
                segs = drain()
                if any(g.duration > 1.0 for g in segs):
                    long_audio.add(index)
                return segs
            s.processor.drain_audio = drain_long

    # one DQPSK launch a chunk for each of the two digital banks (gain 0.3
    # for c4fm, 0.4 for dmr) and one bit-timing launch for the ltr bank
    run = drive(orch, {"dqpsk": 1, "dqpsk_dmr": 1, "bit_timing_ltr": 1},
                total, MB_WARMUP)
    granted = _granted(orch, hz[1], "c4fm")
    by_kind = {k: [s for s in orch.slots if s.kind == k and s.active
                   and not s.is_control and s is not granted]
               for k, _ in MULTIBANK}
    calls = []
    for s, want in zip(by_kind["ltr"], ident):
        own = [m for m in s.processor.messages
               if m.message_type.name == "CALL"
               and (m.home, m.group) == want]
        calls.append(len(own))
        seg = s.processor.audio.segment
        if seg is not None and seg.duration > 1.0:
            long_audio.add(s.index)
    dmr_frames = [s.processor.frame_count for s in by_kind["dmr"]]
    c4fm_frames = [s.processor.frame_count for s in by_kind["c4fm"]]
    segs = [s for s in orch.audio_segments if s.duration > 0]
    result = {
        "card": card, "banks": MULTIBANK, "slots": SLOT_COUNT,
        "wideband_msps": FS / 1e6, "chunk_samples": orch.chunk_samples,
        "timed_chunks": MB_TIMED,
        "traffic_frames": None if granted is None
        else granted.processor.frame_count,
        "c4fm_voice_slots_with_frames": sum(f > 0 for f in c4fm_frames),
        "dmr_voice_slots_with_frames": sum(f > 0 for f in dmr_frames),
        "ltr_slots_with_own_call_words": sum(c > 0 for c in calls),
        "ltr_slots_with_audio_over_1s": len(long_audio),
        "audio_segments": len(segs), "events": len(orch.events),
        "active_channels": run["metrics"].get("active_channels"),
        **_loop_record(orch, chunks[-1], run),
        "synthesis_s": synth_s}
    print("[live multibank] " + json.dumps(result), flush=True)
    if granted is None or not granted.processor.frame_count:
        raise AssertionError("multibank: the P25 grant was not followed, or "
                             "no frames on the granted slot")
    if not all(c4fm_frames) or not all(dmr_frames):
        raise AssertionError(f"multibank: frames C4FM {c4fm_frames}, DMR "
                             f"{dmr_frames}")
    if not all(calls) or len(long_audio) != n_ltr:
        raise AssertionError(f"multibank: LTR CALL words of the slot's own "
                             f"group {calls}, audio over 1 s on "
                             f"{len(long_audio)} of {n_ltr}")
    if not segs:
        raise AssertionError("multibank: no AudioSegment")
    return result


def _nvidia_holders(pids) -> dict:
    """Which of `pids` hold the card: the compute apps nvidia-smi lists,
    and each pid's open /dev/nvidia* files (a CUDA context opens the
    device files; importing torch does not)."""
    import os

    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    listed = {int(p) for p in out.split() if p.strip().isdigit()}
    held = {}
    for pid in pids:
        fd_dir = f"/proc/{pid}/fd"
        names = set()
        for fd in os.listdir(fd_dir):
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                names.add(target)
        held[pid] = {"nvidia_smi": pid in listed,
                     "device_files": sorted(names)}
    return held


def run_worker(card: str) -> dict:
    """Phase 5's 1023-slot C4FM bank with host_process=True: the bank's
    host layer in a worker process, 2 + 3 chunks, phase 5's coverage
    checks. While it runs, the worker must hold no CUDA context: its pid
    not among nvidia-smi's compute apps and no /dev/nvidia* file open,
    where this process holds the device files."""
    import os

    ch, offsets, chunks, synth_s = _c4fm_scene()
    orch, traffic_hz, voice_hz = _c4fm_orchestrator(chunks, offsets,
                                                    host_process=True)
    try:
        worker_pid = orch.bank_host._proc.pid
        seen = {}

        def check_context(o):
            seen.update(_nvidia_holders([os.getpid(), worker_pid]))

        run = drive(orch, {"dqpsk": 1}, WORKER_WARMUP + WORKER_TIMED,
                    WORKER_WARMUP, before_timed=check_context)
        after = _nvidia_holders([os.getpid(), worker_pid])
        found, check = _c4fm_checks(orch, traffic_hz, voice_hz)
        phase5 = _C4FM.get("result", {})
        result = {
            "card": card, "decoder": "c4fm", "slots": SLOTS,
            "host_process": True, "worker_pid": worker_pid,
            "timed_chunks": WORKER_TIMED, **found,
            "active_channels": run["metrics"].get("active_channels"),
            **_loop_record(orch, chunks[-1], run),
            "phase5_realtime_factor": phase5.get("realtime_factor"),
            "phase5_host_ms_per_chunk": phase5.get("host_ms_per_chunk"),
            "card_holders": {"during": {str(k): v for k, v in seen.items()},
                             "after": {str(k): v for k, v in after.items()}},
            "synthesis_s": synth_s}
        print("[live worker] " + json.dumps(result), flush=True)
        check()
        for held in (seen, after):
            me, worker = held[os.getpid()], held[worker_pid]
            if not me["device_files"]:
                raise AssertionError("worker: this process shows no "
                                     "/dev/nvidia* file, so the check "
                                     "cannot see a context")
            if worker["nvidia_smi"] or worker["device_files"]:
                raise AssertionError(f"worker: the worker process holds the "
                                     f"card: {worker}")
        if not orch.bank_host._proc.is_alive():
            raise AssertionError("worker: the worker process died")
    finally:
        orch.close()
    return result


# --- the application: cli, monitor, monitor_mixed --------------------------

# where the application phases write their captures, playlists and what the
# CLI writes (git-ignored; removed after each phase)
APP_DIR = ROOT / ".scratch" / "chip_smoke"
DECODE_RATE = 25000.0            # the decode captures' channel rate
DECODE_RATE_48K = 48000.0        # the capture decoded at W = 20
MONITOR_CHUNKS = WARMUP + TIMED  # phase 5's scene, 3 + 4 chunks
LTR_IDENT = (3, 33)              # the LTR control channel's (home, group)


def _write_iq(path: Path, iq, rate: float) -> Path:
    from sdrtrunk_tpu_torch.io.wave import write_complex_wave
    write_complex_wave(path, iq, int(rate))
    return path


def decode_scenes(directory: Path) -> list:
    """The single-channel captures ``cli`` decodes, each at most half a
    second: [(scene, protocol, wave path, extra flags, kernels-line entry
    its decode launches)]. At 25 kHz: P25 Phase 1, tests/test_cli.py's
    capture (two TSBKs); DMR, the TSCC control stream of phase 8 (an aloha
    and Tier III grants); P25 Phase 2, one call cycle of phase 6 (its
    scramble key on the command line); LTR, an NBFM carrier with the voice
    tone and sub-audible CALL words; MPT1327, phase 12's control channel.
    And the P25 Phase 1 capture at 48 kHz, a sound card's rate, which the
    CLI decodes at its own rate (DQPSK at W = 20)."""
    import numpy as np

    from sdrtrunk_tpu_torch.protocol.ltr.messages import ltr_encode_word
    from sdrtrunk_tpu_torch.protocol.p25p1 import (DUID,
                                                   P25P1FrameAssembler)
    from sdrtrunk_tpu_torch.protocol.p25p1.tsbk import tsbk_encode
    from sdrtrunk_tpu_torch.signal.generators import (c4fm_modulate,
                                                      lsm_modulate,
                                                      nbfm_modulate)

    rate = DECODE_RATE
    rng = np.random.default_rng(0)
    asm = P25P1FrameAssembler(nac=0x2F7)
    parts = [rng.integers(0, 4, 50).astype(np.uint8)]
    for opcode in (0x3B, 0x00):
        parts.append(asm.assemble(
            DUID.TSBK, tsbk_encode(opcode, rng.integers(0, 2, 64))))
        parts.append(rng.integers(0, 4, 20).astype(np.uint8))
    p25 = c4fm_modulate(np.concatenate(parts), rate)
    dmr = c4fm_modulate(_dmr_streams(2400)[0], rate)
    p25p2 = lsm_modulate(_p25p2_cycle(), sample_rate=rate,
                         symbol_rate=6000.0)
    n_audio = int(0.5 * 8000)
    word = ltr_encode_word(0, LTR_IDENT[0], *LTR_IDENT, LTR_IDENT[0])
    bits = np.tile(word, n_audio // 26 // len(word) + 2)
    sym = (np.arange(n_audio) * 300.0 / 8000.0).astype(np.int64)
    audio = (0.35 * (2.0 * bits[sym] - 1.0)
             + 0.5 * np.sin(2 * np.pi * VOICE_TONE_HZ / 8000.0
                            * np.arange(n_audio)))
    ltr = nbfm_modulate(audio, 8000.0, rate)
    mpt = _mpt_control(int(0.5 * rate), rate, np.random.default_rng(13))
    p25_48k = c4fm_modulate(np.concatenate(parts), DECODE_RATE_48K)
    key = [str(k) for k in P25P2_KEY]
    return [
        ("p25p1", "p25p1", _write_iq(directory / "p25.wav", p25, rate), [],
         "dqpsk"),
        ("dmr", "dmr", _write_iq(directory / "dmr.wav", dmr, rate), [],
         "dqpsk_dmr"),
        ("p25p2", "p25p2", _write_iq(directory / "p25p2.wav", p25p2, rate),
         ["--wacn", key[0], "--system", key[1], "--nac", key[2]],
         "gardner_p25p2"),
        ("ltr", "ltr", _write_iq(directory / "ltr.wav", ltr, rate), [],
         "bit_timing_ltr"),
        ("mpt1327", "mpt1327",
         _write_iq(directory / "mpt1327.wav", mpt, rate), [],
         "bit_timing_afsk"),
        ("p25p1_48k", "p25p1",
         _write_iq(directory / "p25_48k.wav", p25_48k, DECODE_RATE_48K), [],
         "dqpsk_w20")]


def replay_scene(directory: Path) -> tuple[Path, Path, float]:
    """tests/test_cli.py's two-channel P25 capture (test_cli_replay_
    batched_digital): the same TSBK twice behind an alternating preamble,
    at +25 kHz and -50 kHz of a 400 kHz capture. Returns (capture,
    playlist, center frequency)."""
    import numpy as np

    from sdrtrunk_tpu_torch.config import (ChannelConfig, DecodeConfig,
                                           Playlist, SourceConfig)
    from sdrtrunk_tpu_torch.protocol.p25p1.duid import DUID
    from sdrtrunk_tpu_torch.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_tpu_torch.protocol.p25p1.tsbk import tsbk_encode
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    fs = 400_000.0
    center = 851_000_000.0
    rng = np.random.default_rng(2)
    asm = P25P1FrameAssembler(nac=0x293)
    tsbk = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    preamble = np.tile([1, 3], 150).astype(np.uint8)
    dibits = np.concatenate([
        preamble, tsbk, rng.integers(0, 4, 20).astype(np.uint8),
        tsbk, rng.integers(0, 4, 20).astype(np.uint8)])
    chan_iq = c4fm_modulate(dibits, fs)
    offs = [2 * 12500.0, -4 * 12500.0]
    n = (len(chan_iq) // 32) * 32
    t = np.arange(n)
    wb = sum(chan_iq[:n] * np.exp(2j * np.pi * o * t / fs)
             for o in offs).astype(np.complex64)
    cap = _write_iq(directory / "wb2.wav", wb, fs)
    playlist = directory / "pl2.json"
    Playlist(channels=[
        ChannelConfig(name=f"P25-{i}",
                      source=SourceConfig(frequency_hz=center + o),
                      decode=DecodeConfig(decoder="p25p1", nac=0x293))
        for i, o in enumerate(offs)]).save(playlist)
    return cap, playlist, center


class _Lines:
    """A stdout that keeps each printed line and the perf_counter time at
    which it was printed."""

    def __init__(self):
        self.lines, self.times, self._part = [], [], ""

    def write(self, text: str) -> int:
        self._part += text
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append(line)
            self.times.append(time.perf_counter())
        return len(text)

    def flush(self) -> None:
        pass


def _kernel_calls():
    """Patch the calls that reach the kernel wrappers (the symbol loops'
    ``_kernel``, the demodulators' ``bit_timing``) to record (kernels-line
    entry, C, T) of each CUDA launch; returns (the list, undo)."""
    from sdrtrunk_tpu_torch.dsp import afsk, fsk, psk

    entry_of = {key: entry for entry, key in _ENTRY_KEYS.items()}
    seen, undo = [], []

    def patch(owner, name, key):
        fn = getattr(owner, name)

        def spy(*args, **kw):           # (demod or geometry, x, ...)
            x = args[1]
            if x.device.type == "cuda":
                seen.append((entry_of[key(args)], *x.shape))
            return fn(*args, **kw)
        setattr(owner, name, spy)
        undo.append(lambda: setattr(owner, name, fn))

    patch(psk.DQPSKDemodulator, "_kernel",
          lambda a: ("dqpsk", (a[0].sample_counter_gain, a[0].window_len)))
    patch(psk.GardnerDQPSKDemodulator, "_kernel",
          lambda a: ("gardner", a[0].window_len))
    for mod in (fsk, afsk):
        patch(mod, "bit_timing", lambda a: ("bit_timing",
                                            a[0].window_len))
    return seen, lambda: [u() for u in undo]


def _run_cli(argv: list, on_session=None) -> dict:
    """The port's CLI in this process, as ``python -m
    sdrtrunk_tpu_torch.cli`` runs it (``cli.main``), its stdout captured;
    every kernel's launch count set to 0 just before and read just after.
    ``on_session(session)`` sees a monitor's MonitorSession as soon as it
    is built. Returns the lines, their print times, the JSON lines, the
    launches and the shapes of the launches; raises unless it exits 0."""
    import contextlib

    import torch

    from sdrtrunk_tpu_torch import cli, monitor

    out = _Lines()
    init = monitor.MonitorSession.__init__

    def spy_init(session, *args, **kw):
        init(session, *args, **kw)
        if on_session is not None:
            on_session(session)
    monitor.MonitorSession.__init__ = spy_init
    shapes, undo = _kernel_calls()
    try:
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        monitor.MonitorSession.__init__ = init
        undo()
    if rc != 0:
        raise AssertionError(f"cli {' '.join(map(str, argv))} exited {rc}")
    rows = []
    for line in out.lines:
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            rows.append(None)
    return {"lines": out.lines, "times": out.times, "rows": rows,
            "launches": launches, "shapes": shapes, "wall_s": wall}


def _messages(run: dict) -> list:
    return [line for line, row in zip(run["lines"], run["rows"])
            if isinstance(row, dict) and not row.get("summary")]


def run_cli(card: str) -> dict:
    """``decode`` of each decode scene on the card and again with
    ``--platform cpu`` (the plain loops), then ``replay`` of the
    two-channel capture both ways: the message lines identical, one launch
    a decode on the card (DQPSK at gain 0.3 and 0.4, Gardner W = 16, bit
    timing W = 53 and W = 12) and one DQPSK launch at C = 2 for the
    replay, none with ``--platform cpu``."""
    import shutil

    APP_DIR.mkdir(parents=True, exist_ok=True)
    try:
        runs = []
        launches = {entry: 0 for entry in _ENTRY_KEYS}
        shapes = set()
        cap, playlist, center = replay_scene(APP_DIR)
        commands = [(f"decode {scene}",
                     ["decode", path, "--protocol", p, *flags], {entry: 1})
                    for scene, p, path, flags, entry
                    in decode_scenes(APP_DIR)]
        commands.append(("replay p25p1 x2",
                         ["replay", cap, "--playlist", playlist,
                          "--center-frequency", center],
                         {"dqpsk": 1, "channelize": 1}))
        for name, argv, expect in commands:
            card_run = _run_cli(argv)
            cpu_run = _run_cli(["--platform", "cpu", *argv])
            got, want = _messages(card_run), _messages(cpu_run)
            want_launches = {e: expect.get(e, 0) for e in _ENTRY_KEYS}
            record = {"command": name, "messages": len(got),
                      "card_wall_ms": card_run["wall_s"] * 1e3,
                      "cpu_wall_ms": cpu_run["wall_s"] * 1e3,
                      "launches": {e: n for e, n in
                                   card_run["launches"].items() if n},
                      "shapes": card_run["shapes"]}
            runs.append(record)
            print("[cli] " + json.dumps(record), flush=True)
            if not got:
                raise AssertionError(f"cli {name}: no messages decoded")
            if got != want:
                raise AssertionError(f"cli {name}: the card's messages differ "
                                     f"from --platform cpu's:\n{got}\n{want}")
            if card_run["launches"] != want_launches:
                raise AssertionError(f"cli {name}: launches "
                                     f"{card_run['launches']}, expected "
                                     f"{want_launches}")
            if any(cpu_run["launches"].values()) or cpu_run["shapes"]:
                raise AssertionError(f"cli {name}: a kernel launched under "
                                     "--platform cpu")
            for entry, n in card_run["launches"].items():
                launches[entry] += n
            shapes.update(card_run["shapes"])
        if ("dqpsk", 2) not in {(e, c) for e, c, _ in shapes}:
            raise AssertionError(f"cli: replay launched no DQPSK kernel at "
                                 f"C = 2 ({sorted(shapes)})")
    finally:
        shutil.rmtree(APP_DIR, ignore_errors=True)
    return {"card": card, "commands": runs, "kernel_launches": launches}


def _timed_host(orch, calls: list, framed: list) -> None:
    """Time the live loop's host layer (``_host_layer``) call by call into
    `calls`, count the messages a bank framer's ``frame_chunk`` returns
    into `framed`, and check that every live-step output lies on the
    card."""
    host_obj, layer = _host_layer(orch)
    fn = getattr(host_obj, layer)
    step = orch.step

    def timed(*args):
        f0 = time.perf_counter()
        try:
            out = fn(*args)
        finally:
            calls.append(time.perf_counter() - f0)
        if isinstance(out, list):
            framed.append(len(out))
        return out
    setattr(host_obj, layer, timed)

    def spy_step(*args):
        out, st = step(*args)
        devices = {v.device.type for v in out.values()}
        if devices != {"cuda"}:
            raise AssertionError(f"live step outputs on {devices}")
        return out, st
    orch.step = spy_step


def _monitor_record(run: dict, orch, host_calls: list, chunk: int,
                    warmup: int, iq) -> dict:
    """Realtime factor, wall and host ms a chunk over the timed chunks of
    a monitor run (from the print times of its per-chunk metrics lines),
    the device's busy ms a chunk and idle share, the host's CPU."""
    import bench_torch

    times = [t for t, row in zip(run["times"], run["rows"])
             if isinstance(row, dict) and "t" in row]
    timed = len(times) - warmup
    wall = (times[-1] - times[warmup - 1]) / timed
    busy = device_busy_ms(orch, iq)
    return {"chunks": len(times), "timed_chunks": timed,
            "realtime_factor": chunk / wall / orch.sample_rate,
            "wall_ms_per_chunk": wall * 1e3,
            "host_layer": _host_layer(orch)[1],
            "host_ms_per_chunk": sum(host_calls[-timed:]) * 1e3 / timed,
            "device_busy_ms_per_chunk": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            **bench_torch._host()}


def _event_rows(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


def run_monitor(card: str) -> dict:
    """The slice's path at full width: phase 5's scene (12.8 MS/s, M =
    1024, a P25 control channel granting a traffic channel, voice carriers
    on the other bins) as a 16-bit IQ wave of 3 + 4 chunks, a playlist of
    the control channel alone, and ``monitor --bank --traffic-slots
    1022``: 1023 slots in bank mode, one DQPSK launch a chunk at C = 1023.
    The grant must be in the event log and followed (frames on the granted
    slot, a call written as WAV and sidecar)."""
    import shutil

    import numpy as np

    from sdrtrunk_tpu_torch.config import (ChannelConfig, DecodeConfig,
                                           Playlist, SourceConfig)

    ch, offsets, chunks, synth_s = _c4fm_scene()
    APP_DIR.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        iq = np.concatenate([c[:, 0] + 1j * c[:, 1] for c in chunks]
                            ).astype(np.complex64) / 128.0
        wave = _write_iq(APP_DIR / "scene.wav", iq, FS)
        del iq
        write_s = time.perf_counter() - t0
        playlist = APP_DIR / "p.json"
        Playlist(channels=[ChannelConfig(
            name="Control", system="Scene", site="Site1",
            source=SourceConfig(frequency_hz=CENTER_HZ + offsets[0]),
            decode=DecodeConfig(decoder="p25p1"))]).save(playlist)
        audio = APP_DIR / "audio"
        events = audio / "events.jsonl"
        sessions, host_calls, framed = [], [], []

        def on_session(session):
            sessions.append(session)
            _timed_host(session.orch, host_calls, framed)
        chunk = M * CHUNK_BLOCKS
        run = _run_cli(["monitor", "--playlist", playlist, "--input", wave,
                        "--center-frequency", CENTER_HZ, "--bank",
                        "--traffic-slots", SLOTS - 1,
                        "--chunk-samples", chunk,
                        "--max-chunks", MONITOR_CHUNKS,
                        "--audio-dir", audio, "--event-log", events],
                       on_session)
        orch = sessions[0].orch
        header = next(r for r in run["rows"] if r and r.get("monitor"))
        summary = run["rows"][-1]
        traffic_hz = CENTER_HZ + offsets[TRAFFIC_INDEX]
        status = orch.channel_status()
        traffic_frames = sum(
            s["frames"] for s in status
            if not s["control"] and abs(s["frequency_hz"] - traffic_hz) < 1.0)
        grant_rows = [r for r in _event_rows(events)
                      if abs((r.get("frequency_hz") or 0) - traffic_hz) < 1.0]
        wavs = sorted(audio.glob("call_*.wav"))
        sidecars = [w for w in wavs if w.with_suffix(".wav.json").exists()]
        last = (chunks[-1][:, 0] + 1j * chunks[-1][:, 1]).astype(
            np.complex64) / 128.0
        phase5 = _C4FM.get("result", {})
        result = {
            "card": card, "slots": header["slots"],
            "bank_mode": header["bank_mode"], "chunk_samples": chunk,
            "grant_events": len(grant_rows), "traffic_frames": traffic_frames,
            "active_slots": sum(s["active"] for s in status),
            "frames": sum(s["frames"] for s in status),
            "frames_on_inactive_slots": sum(s["frames"] for s in status
                                            if not s["active"]),
            "messages_framed": sum(framed),
            "calls_written": len(wavs), "sidecars": len(sidecars),
            "events": summary.get("events"),
            "launches": {e: n for e, n in run["launches"].items() if n},
            **_monitor_record(run, orch, host_calls, chunk, WARMUP, last),
            "phase5_realtime_factor": phase5.get("realtime_factor"),
            "phase5_host_ms_per_chunk": phase5.get("host_ms_per_chunk"),
            "wave_write_s": write_s, "synthesis_s": synth_s}
        print("[app monitor] " + json.dumps(result), flush=True)
        if header["bank_mode"] is not True or header["slots"] != SLOTS:
            raise AssertionError(f"monitor: header {header}")
        if not grant_rows:
            raise AssertionError("monitor: the grant is not in the event log")
        if not traffic_frames:
            raise AssertionError("monitor: no frames on the granted slot")
        if not sidecars:
            raise AssertionError("monitor: no call written as WAV and "
                                 "sidecar")
        want = {e: MONITOR_CHUNKS * (e in ("dqpsk", "channelize"))
                for e in _ENTRY_KEYS}
        if run["launches"] != want:
            raise AssertionError(f"monitor: launches {run['launches']}, "
                                 f"expected {want}")
        if {(e, c) for e, c, _ in run["shapes"]} != {("dqpsk", SLOTS)}:
            raise AssertionError(f"monitor: kernel shapes {run['shapes']}")
    finally:
        shutil.rmtree(APP_DIR, ignore_errors=True)
    return {**result, "kernel_launches": run["launches"]}


def _parse_mp2(data: bytes) -> int:
    """The number of MPEG-1 Layer II frames in data, each checked: 432
    bytes (96 kbps at 32 kHz, no padding), sync 0xFFF, MPEG-1, layer II,
    no CRC, bitrate index 6, 32 kHz, single channel."""
    if not data or len(data) % 432:
        raise AssertionError(f"mp2: {len(data)} bytes, not whole frames")
    for i in range(0, len(data), 432):
        h = int.from_bytes(data[i:i + 4], "big")
        fields = (h >> 20, (h >> 19) & 1, (h >> 17) & 3, (h >> 16) & 1,
                  (h >> 12) & 15, (h >> 10) & 3, (h >> 6) & 3)
        if fields != (0xFFF, 1, 0b10, 1, 6, 0b10, 0b11):
            raise AssertionError(f"mp2: frame {i // 432} header {h:08x}")
    return len(data) // 432


def run_monitor_mixed(card: str) -> dict:
    """A playlist of three control channels, one of each bank kind: P25
    Phase 1 (phase 5's control stream, its IDEN_UP announcing band 0 and
    granting a channel there), DMR (phase 8's TSCC: an aloha and Tier III
    grants, which the traffic manager's one band plan maps) and LTR (a
    voice carrier with CALL words of its own group); the two granted
    channels carry their calls. ``monitor --traffic-slots 4`` gives banks
    [(c4fm, 5), (dmr, 5), (ltr, 5)] through MultibankReceiver; the LTR
    channel records mp2 (so every call is written as MPEG-1 Layer II) and
    the P25 channel its dibits (the bits tap). The scene is built on the
    host (``bench_torch.mixed_monitor_inputs``, as the ``reference``
    phase's hold of it).

    Both grants must be followed (a slot tuned to the channel, the grant
    in the event log) and the P25 one decoded there. With ``banks=`` every
    grant starts a slot of the first bank's kind (``Orchestrator._activate``
    as in the reference, ROADMAP Queue 3), so the DMR grant's slot is a
    C4FM one and decodes nothing; the record shows its kind."""
    import shutil

    import bench_torch
    from sdrtrunk_tpu_torch.audio.recorder import BitsReader
    from sdrtrunk_tpu_torch.protocol.p25p1 import P25P1Framer

    slots, ident = bench_torch.MIXED_SLOTS, bench_torch.LTR_IDENT
    hz = {k: CENTER_HZ + _offset(i)
          for k, i in bench_torch.MIXED_CHANNELS.items()}
    APP_DIR.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        inputs = bench_torch.mixed_monitor_inputs(APP_DIR)
        synth_s = time.perf_counter() - t0
        audio, events = inputs["audio"], inputs["events"]
        sessions, host_calls = [], []

        def on_session(session):
            sessions.append(session)
            _timed_host(session.orch, host_calls, [])
        chunk = M * bench_torch.MIXED_BLOCKS
        chunks = bench_torch.MIXED_CHUNKS
        run = _run_cli(inputs["argv"], on_session)
        session = sessions[0]
        orch = session.orch
        header = next(r for r in run["rows"] if r and r.get("monitor"))
        controls = {s.name: s for s in orch.slots if s.is_control}
        decoded = {
            "p25_frames": controls["P25"].processor.frame_count,
            "dmr_frames": controls["DMR"].processor.frame_count,
            "ltr_own_call_words": sum(
                1 for m in controls["LTR"].processor.messages
                if m.message_type.name == "CALL"
                and (m.home, m.group) == ident)}
        rows = _event_rows(events)
        followed = {}
        for grant in ("p25_traffic", "dmr_traffic"):
            slot = _granted(orch, hz[grant])
            followed[grant] = {
                "events": sum(abs((r.get("frequency_hz") or 0) - hz[grant])
                              < 1.0 for r in rows),
                "slot_kind": None if slot is None else slot.kind,
                "frames": 0 if slot is None else slot.processor.frame_count}
        mp2 = sorted(audio.glob("call_*.mp2"))
        mp2_frames = [_parse_mp2(p.read_bytes()) for p in mp2]
        dibits = BitsReader.read(audio / "P25.bits")
        tsbks = sum(1 for m in P25P1Framer().process(dibits)
                    if m.duid.name == "TSBK")
        result = {
            "card": card, "banks": [list(b) for b in orch.banks],
            "slots": header["slots"], "bank_mode": header["bank_mode"],
            "chunk_samples": chunk, **decoded, "followed": followed,
            "skipped_grants": len(orch.skipped_grants),
            "mp2_calls": len(mp2), "mp2_frames": mp2_frames,
            "bits_tap_dibits": len(dibits), "bits_tap_tsbks": tsbks,
            "launches": {e: n for e, n in run["launches"].items() if n},
            **_monitor_record(run, orch, host_calls, chunk, 2,
                              inputs["last"]),
            "synthesis_s": synth_s}
        print("[app monitor_mixed] " + json.dumps(result), flush=True)
        want_banks = [("c4fm", 1 + slots), ("dmr", 1 + slots),
                      ("ltr", 1 + slots)]
        if orch.banks != want_banks:
            raise AssertionError(f"monitor_mixed: banks {orch.banks}")
        if not all(decoded.values()):
            raise AssertionError(f"monitor_mixed: a control channel decoded "
                                 f"nothing: {decoded}")
        for grant, seen in followed.items():
            if not seen["events"] or seen["slot_kind"] is None:
                raise AssertionError(f"monitor_mixed: the {grant} grant was "
                                     f"not followed: {seen}")
        if followed["p25_traffic"]["slot_kind"] != "c4fm" \
                or not followed["p25_traffic"]["frames"]:
            raise AssertionError(f"monitor_mixed: no P25 frames on the "
                                 f"granted slot: {followed}")
        if not mp2 or not all(mp2_frames):
            raise AssertionError("monitor_mixed: no parsable .mp2 call")
        if len(dibits) < 0.9 * chunks * chunk / FS * 4800 or not tsbks:
            raise AssertionError(f"monitor_mixed: the bits tap holds "
                                 f"{len(dibits)} dibits, {tsbks} TSBKs")
        want = {e: chunks * (e in ("dqpsk", "dqpsk_dmr", "bit_timing_ltr",
                                   "channelize"))
                for e in _ENTRY_KEYS}
        if run["launches"] != want:
            raise AssertionError(f"monitor_mixed: launches "
                                 f"{run['launches']}, expected {want}")
    finally:
        shutil.rmtree(APP_DIR, ignore_errors=True)
    return {**result, "kernel_launches": run["launches"]}


# --- channelize: the channelizer's branch-sum kernel ------------------------

CHANNELIZE_SOURCE = "sdrtrunk_tpu_torch/csrc/channelize.cu"
# the bank cells' chunks, blocks of M samples: c4fm_bank_1023 and
# nbfm_bank_1023 (benchmark/traffic/*.json)
CHANNELIZE_BLOCKS = {"c4fm_bank": 20480, "nbfm_bank": 25600}


def _bits_equal(a, b) -> bool:
    import torch
    return torch.equal(torch.view_as_real(a).view(torch.int32),
                       torch.view_as_real(b).view(torch.int32))


def check_channelize(card: str) -> dict:
    """The branch-sum kernel at the bank cells' shapes (M = 1024 bins, T =
    9 taps of the designed prototype, K = 2 x CHANNELIZE_BLOCKS, a random
    nonzero history): u and channelize_core's y held bit for bit against
    ``branch_sums_plain`` and ``channelize_core_plain`` on the card; the
    kernel timed through its wrapper by CUDA events (5 calls) and alone
    behind a sleep (``_device_span_ms``) beside its bytes bound (xp and the
    branches read once, u written once, over the memory rate), the plain
    sums once; the layer (sums, inverse FFT, flip) both ways. No PyTorch
    call computes the sums (library_ms None). Returns the kernels-line
    entry, the second shape under "nbfm_bank"."""
    import torch

    from sdrtrunk_tpu_torch.dsp.channelize_cuda import channelize_cuda
    from sdrtrunk_tpu_torch.dsp.channelizer import (Channelizer,
                                                    branch_sums_plain,
                                                    channelize_core,
                                                    channelize_core_plain)

    hmat = Channelizer.design(FS, 12500.0, device="cuda").hmat
    t, m = hmat.shape
    gen = torch.Generator(device="cuda").manual_seed(27)
    records = {}
    for cell, blocks in CHANNELIZE_BLOCKS.items():
        n = m * blocks
        k = 2 * n // m
        xp = torch.view_as_complex(torch.randn(
            (t * m + n, 2), generator=gen, device="cuda") / 4)
        plain = {}
        plain_ms = _cuda_ms(lambda: plain.update(u=branch_sums_plain(xp,
                                                                     hmat)))
        if not _bits_equal(channelize_cuda(xp, hmat), plain.pop("u")):
            raise AssertionError(f"channelize {cell}: the kernel's u differs "
                                 "from branch_sums_plain on the card")
        if not _bits_equal(channelize_core(xp, hmat),
                           channelize_core_plain(xp, hmat)):
            raise AssertionError(f"channelize {cell}: channelize_core's y "
                                 "differs from channelize_core_plain on the "
                                 "card")
        ms = _cuda_ms(lambda: channelize_cuda(xp, hmat), reps=5)
        device_ms = _device_span_ms(lambda: channelize_cuda(xp, hmat))
        layer_ms = _cuda_ms(lambda: channelize_core(xp, hmat), reps=5)
        layer_device_ms = _device_span_ms(lambda: channelize_core(xp, hmat))
        layer_plain_ms = _cuda_ms(lambda: channelize_core_plain(xp, hmat),
                                  reps=3)
        bound_ms = (8 * xp.numel() + 4 * hmat.numel() + 8 * k * m) \
            / HBM_BYTES_PER_S * 1e3
        records[cell] = {
            "name": "channelize", "route": "cuda",
            "source": CHANNELIZE_SOURCE, "replaces": None,
            "max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "shape": [k, m], "plain_shape": [k, m],
            "taps": t, "layer_ms": layer_ms,
            "layer_device_ms": layer_device_ms,
            "layer_plain_ms": layer_plain_ms}
        print(f"[channelize] {card}: {cell} M = {m}, T = {t}, K = {k}: u and "
              f"y identical to the plain versions on the card; kernel "
              f"{ms:.4f} ms, device {device_ms:.4f} ms against a "
              f"{bound_ms:.4f} ms bytes bound ({100 * bound_ms / device_ms:.2f}"
              f"% of it), plain sums {plain_ms:.3f} ms; layer {layer_ms:.4f} "
              f"ms, device {layer_device_ms:.4f}, plain {layer_plain_ms:.3f} "
              f"ms", flush=True)
    return {**records["c4fm_bank"], "nbfm_bank": records["nbfm_bank"]}


# --- parity: the golden captures, the parity reports, per-channel calls ---

GOLDEN_DIR = ROOT / "tests" / "golden"
# (kernels-line entry -> launches) of the parity phase: the three golden
# decodes, the four reports, the LTR and MPT1327 per-channel calls, the
# checkpoint round trip's three C4FM chunks (the first, the resumed second
# and the second without the save), the decision-timed P25P2 decode and
# the LTR decodes of 16 and 48 kHz audio
PARITY_LAUNCHES = {"dqpsk": 6, "dqpsk_dmr": 2, "gardner_lsm": 2,
                   "bit_timing_ltr": 1, "bit_timing_afsk": 1,
                   "dqpsk_p25p2": 1, "bit_timing_w106": 1,
                   "bit_timing_w320": 1}
LTR_WIDE_BITS = 150              # 0.5 s of 300-baud FSK
PER_CHANNEL_K = 12500            # 0.5 s at 25 kHz: Ka = 4000, T = 3600 AFSK
AUDIO_TOL = 1e-4                 # tests/test_torch_per_channel.py's


def _golden(card: str) -> list:
    """The three golden captures on the card: the port's float64 oracle
    writes .bits files equal in bytes to tests/golden/ (write_golden into
    a scratch directory), and the card's per-channel decode of each
    capture, one launch at C = 1, frames manifest.json's events."""
    from sdrtrunk_tpu_torch import parity

    with open(GOLDEN_DIR / "manifest.json") as f:
        manifest = json.load(f)
    out = APP_DIR / "golden"
    written = parity.write_golden(str(out))
    for name in ("c4fm.bits", "dmr.bits", "lsm.bits", "manifest.json"):
        if (out / name).read_bytes() != (GOLDEN_DIR / name).read_bytes():
            raise AssertionError(f"parity: {name} differs from "
                                 f"tests/golden/{name}")
    rows = []
    for protocol, (iq, dec, oracle) in parity.golden_captures().items():
        if dec.baseband_taps.device.type != "cuda":
            raise AssertionError("parity: a golden decoder is not on the card")
        device = parity.decode_dibits(dec, iq)
        events = parity.golden_events(protocol, device)
        n = min(len(device), len(oracle))
        row = {"protocol": protocol, "samples": len(iq),
               "oracle_dibits": len(oracle), "device_dibits": len(device),
               "agreement": float((device[100:n] == oracle[100:n]).mean()),
               "events": len(events),
               "events_match": events == manifest[protocol]["events"]}
        rows.append(row)
        if not row["events_match"] or written[protocol] != manifest[protocol]:
            raise AssertionError(f"parity: golden {protocol}: {row}")
    print(f"[parity] {card}: golden .bits equal in bytes to tests/golden/; "
          + json.dumps(rows), flush=True)
    return rows


def _reports(card: str) -> list:
    """The reference's four parity reports with the device half on the
    card, each printed and held to the reference's main() rule."""
    from sdrtrunk_tpu_torch import parity

    APP_DIR.mkdir(parents=True, exist_ok=True)
    reports = [parity.parity_report(seed=0,
                                    bits_path=str(APP_DIR / "parity.bits")),
               parity.parity_report(seed=1, snr_db=12.0),
               parity.parity_report_dmr(), parity.parity_report_gardner()]
    for rep in reports:
        print("[parity] " + json.dumps(rep), flush=True)
        ok = (rep["events_match"]
              and rep["frames_device"] == rep["frames_expected"]
              and rep.get("device_ber_vs_truth", 0.0) < 0.01)
        if not ok:
            raise AssertionError(f"parity: report fails the rule: {rep}")
    if not reports[0]["bits_roundtrip_ok"]:
        raise AssertionError("parity: the .bits round trip failed")
    return reports


def _per_channel_scenes() -> dict:
    """kind -> (decoder maker (device) -> decoder, one channel's 25 kHz
    block of PER_CHANNEL_K samples)."""
    import numpy as np

    from sdrtrunk_tpu_torch.decoders.am import AMDecoder
    from sdrtrunk_tpu_torch.decoders.ltr import (LTRLiveDecoder,
                                                 MPT1327LiveDecoder)
    from sdrtrunk_tpu_torch.decoders.nbfm import NBFMDecoder
    from sdrtrunk_tpu_torch.signal.generators import nbfm_modulate

    rng = np.random.default_rng(31)
    k = PER_CHANNEL_K
    n = np.arange(k * 8 // 25 + 80)
    bits = rng.integers(0, 2, 400)
    fsk = 0.35 * (2.0 * bits[np.minimum((n * 300 / 8000).astype(np.int64),
                                        399)] - 1.0)
    tone = 0.5 * np.sin(2 * np.pi * VOICE_TONE_HZ * n / 8000.0)
    freq = np.where(bits[np.minimum((n * 1200 / 8000).astype(np.int64),
                                    399)] == 1, 1200.0, 1800.0)
    afsk = 0.5 * np.sin(2 * np.pi * np.cumsum(freq) / 8000.0)
    t = np.arange(k) / 25000.0
    am = (1.0 + 0.5 * np.sin(2 * np.pi * AM_TONE_HZ * t)) * np.exp(1j * 0.4)

    def fm(audio):
        return nbfm_modulate(audio, 8000.0, 25000.0)[:k].astype(np.complex64)

    return {"nbfm": (lambda d: NBFMDecoder(device=d), fm(tone)),
            "am": (lambda d: AMDecoder(device=d), am.astype(np.complex64)),
            "ltr": (lambda d: LTRLiveDecoder(device=d), fm(fsk + tone)),
            "mpt1327": (lambda d: MPT1327LiveDecoder(device=d), fm(afsk))}


def _per_channel(card: str) -> dict:
    """The per-channel NBFM, AM, LTR and MPT1327 calls on the card against
    the same calls on the CPU: bits and valid exact, audio within
    AUDIO_TOL, the gate exact."""
    import torch

    found = {}
    for kind, (make, iq) in _per_channel_scenes().items():
        got = {}
        for dev in ("cpu", "cuda"):
            dec = make(dev)
            out, _ = dec(torch.as_tensor(iq, device=dev), dec.init_state())
            got[dev] = {key: v.cpu() for key, v in out.items()}
        card_out, cpu_out = got["cuda"], got["cpu"]
        err = float((card_out["audio"] - cpu_out["audio"]).abs().max())
        found[kind] = {"audio_max_abs_err": err,
                       "audio_samples": int(card_out["audio"].shape[0]),
                       "symbols": int(cpu_out["valid"].sum())
                       if "valid" in cpu_out else None}
        if err > AUDIO_TOL or not torch.equal(card_out["audio_gate"],
                                              cpu_out["audio_gate"]):
            raise AssertionError(f"parity: {kind} on the card: {found[kind]}")
        for key in ("bits", "valid"):
            if key in cpu_out and not torch.equal(card_out[key],
                                                  cpu_out[key]):
                raise AssertionError(f"parity: {kind} {key} on the card "
                                     "differ from the CPU's")
    print(f"[parity] {card}: per-channel calls on the card equal the CPU's "
          + json.dumps(found), flush=True)
    return found


def _checkpoint(card: str) -> dict:
    """A per-channel C4FM decode on the card in two chunks, saved with
    save_state after the first and resumed with load_state: the same
    dibits and valid, and every state leaf, bit for bit, as the same two
    chunks without the save."""
    import torch

    from sdrtrunk_tpu_torch import parity
    from sdrtrunk_tpu_torch.runtime.checkpoint import load_state, save_state
    from sdrtrunk_tpu_torch.tree import tree_leaves

    iq, dec, _ = parity.golden_captures()["c4fm"]
    x = torch.as_tensor(iq, device="cuda")
    split = x.shape[0] // 2
    _, state = dec(x[:split], dec.init_state())
    APP_DIR.mkdir(parents=True, exist_ok=True)
    path = str(APP_DIR / "c4fm_state.npz")
    save_state(path, state, {"position": split})
    restored, meta = load_state(path, dec.init_state())
    if meta["position"] != split or any(
            a.device.type != "cuda" for a in tree_leaves(restored)):
        raise AssertionError("parity: the checkpoint did not load onto the "
                             "card")
    got, got_state = dec(x[split:], restored)
    want, want_state = dec(x[split:], state)
    same = (all(torch.equal(got[k], want[k]) for k in ("dibits", "valid"))
            and all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(got_state), tree_leaves(want_state))))
    record = {"split": split, "symbols": int(want["valid"].sum()),
              "bit_for_bit": same}
    print(f"[parity] {card}: checkpoint round trip " + json.dumps(record),
          flush=True)
    if not same or record["symbols"] < 100:
        raise AssertionError(f"parity: checkpoint resume differs: {record}")
    return record


def _p25p2_decision(card: str) -> dict:
    """tests/test_p25p2.py's modem scene (a fragment of FACCH and VOICE_4
    timeslots, 6000-baud constant-envelope modem at 50 kHz) through
    P25P2Decoder(P25P2Config(timing="decision", sample_counter_gain=0.3))
    on the card, one channel: one DQPSK launch at W = 16, C = 1; the
    fragment framed with its MAC octets and voice frames."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.decoders.p25p2 import P25P2Config, P25P2Decoder
    from sdrtrunk_tpu_torch.protocol.p25p2 import (P25P2FragmentAssembler,
                                                   P25P2Framer)
    from sdrtrunk_tpu_torch.protocol.p25p2.timeslot import (facch_encode,
                                                            voice4_encode)
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    rng = np.random.default_rng(3)
    asm = P25P2FragmentAssembler(*P25P2_KEY)
    info = rng.integers(0, 2, 156).astype(np.uint8)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    frag_bits = asm.assemble(0, [facch_encode(info), voice4_encode(frames),
                                 facch_encode(info), voice4_encode(frames)])
    tx = np.concatenate([rng.integers(0, 4, 60).astype(np.uint8),
                         P25P2FragmentAssembler.to_dibits([frag_bits]),
                         np.zeros(40, np.uint8)])
    iq = c4fm_modulate(tx, 50000.0, symbol_rate=6000.0).astype(np.complex64)
    dec = P25P2Decoder(P25P2Config(timing="decision",
                                   sample_counter_gain=0.3), device="cuda")
    out, _ = dec(torch.as_tensor(iq, device="cuda"), dec.init_state())
    valid = out["valid"].cpu().numpy()
    frags = P25P2Framer(*P25P2_KEY).process(out["dibits"].cpu().numpy()[valid])
    record = {"samples": len(iq), "window": dec.demod.window_len,
              "symbols": int(valid.sum()), "fragments": len(frags),
              "mac_octets_equal": bool(frags) and bool(np.array_equal(
                  frags[0].timeslots[0].mac_octets, info)),
              "voice_frames_equal": bool(frags) and bool(np.array_equal(
                  frags[0].timeslots[1].voice_frames, frames))}
    print(f"[parity] {card}: P25P2 decision timing on the card "
          + json.dumps(record), flush=True)
    if not (record["fragments"] == 1 and record["mac_octets_equal"]
            and record["voice_frames_equal"] and record["window"] == 16):
        raise AssertionError(f"parity: P25P2 decision timing: {record}")
    return record


def _ltr_wide(card: str) -> dict:
    """``LTRDecoder(LTRConfig(audio_rate=rate))`` on the card at
    WIDE_BIT_RATES (16 kHz, W = 106; a sound card's 48 kHz, W = 320): one
    channel's 0.5 s of square 300-baud FSK audio (+/-0.3, DC 0.05, noise),
    one bit-timing launch at C = 1 each; the decoded bits are the sent
    ones past the first and last 8, and the symbols a bit each."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.decoders.ltr import LTRConfig, LTRDecoder

    records = {}
    for which, rate in WIDE_BIT_RATES.items():
        rng = np.random.default_rng(41)
        sent = rng.integers(0, 2, LTR_WIDE_BITS)
        sps = rate / 300.0
        n = np.arange(int(LTR_WIDE_BITS * sps))
        audio = (0.3 * (2.0 * sent[(n / sps).astype(np.int64)] - 1.0) + 0.05
                 + 0.05 * rng.standard_normal(len(n))).astype(np.float32)
        dec = LTRDecoder(LTRConfig(audio_rate=rate), device="cuda")
        out, _ = dec(torch.as_tensor(audio, device="cuda"), dec.init_state())
        got = out["bits"].cpu().numpy()[out["valid"].cpu().numpy()]
        # the decoded stream may lag the sent one by the filter's and the
        # vote's delay: the shift that lines up the middle of the stream
        tail = got[8:-8]
        lags = [k for k in range(8) if np.array_equal(
            tail, sent[8 - k:8 - k + len(tail)])]
        records[which] = {"rate": rate, "samples": len(audio),
                          "window": dec.fsk.window_len,
                          "symbols": len(got), "bits_sent": LTR_WIDE_BITS,
                          "lag": lags[0] if lags else None}
        if not lags or abs(len(got) - LTR_WIDE_BITS) > 2:
            raise AssertionError(f"parity: LTR at {rate} Hz: "
                                 f"{records[which]}")
    print(f"[parity] {card}: LTR at 16 and 48 kHz audio "
          + json.dumps(records), flush=True)
    return records


def run_parity(card: str) -> dict:
    """The golden captures, the four parity reports, the per-channel
    analog and trunking calls, a checkpoint round trip, a decision-timed
    P25P2 decode and LTR decodes of 16 and 48 kHz audio, all on the
    card; every kernel's launch
    count set to 0 just before and read just after, and held to
    PARITY_LAUNCHES."""
    import shutil

    import torch

    _reset_launches()
    t0 = time.perf_counter()
    try:
        result = {"card": card, "golden": _golden(card),
                  "reports": _reports(card),
                  "per_channel": _per_channel(card),
                  "checkpoint": _checkpoint(card),
                  "p25p2_decision": _p25p2_decision(card),
                  "ltr_wide": _ltr_wide(card)}
    finally:
        shutil.rmtree(APP_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    result["wall_s"] = time.perf_counter() - t0
    launches = _read_launches()
    want = {entry: PARITY_LAUNCHES.get(entry, 0) for entry in _ENTRY_KEYS}
    if launches != want:
        raise AssertionError(f"parity: launches {launches}, expected {want}")
    return {**result, "kernel_launches": launches}


# --- receiver: the static build at full width, and the rest of the DSP ----

RECEIVER_WARMUP, RECEIVER_TIMED = 1, 4
FRAMED_VOICE_SLOTS = 64          # voice slots framed on the host (of 1021)


def _framed(dibits, valid, row: int) -> list:
    """The valid P25 Phase 1 frames of row `row` of the chunks' dibits."""
    import numpy as np

    from sdrtrunk_tpu_torch.protocol.p25p1.framer import P25P1Framer
    from sdrtrunk_tpu_torch.protocol.p25p1.messages import decode_frame

    d = np.concatenate([a[row].cpu().numpy()[v[row].cpu().numpy()]
                        for a, v in zip(dibits, valid)])
    return [m for m in map(decode_frame, P25P1Framer().process(d))
            if m.valid]


def _static_build(card: str) -> dict:
    """WidebandReceiver.build() at full width on phase 5's C4FM scene:
    1023 channels at 12.8 MS/s, M = 1024, 1 + 4 chunks of 1024 x 5120 as
    device-resident float32 I/Q pairs (the upload left out, as bench.py's
    receiver bench leaves it). MS/s and the realtime factor of the timed
    chunks by the host clock around work that ends in a synchronize; the
    outputs equal build_dynamic()'s on the same chunks and plan bit for
    bit; the control slot frames its TSBKs, the voice slots their voice
    frames."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.receiver import WidebandReceiver
    from sdrtrunk_tpu_torch.tree import tree_leaves

    ch, offsets, chunks, _ = _c4fm_scene()
    total = RECEIVER_WARMUP + RECEIVER_TIMED
    xs = [torch.as_tensor(c, device="cuda").float() / 127.0
          for c in chunks[:total]]
    rx = WidebandReceiver(FS, offsets, decoder="c4fm", device="cuda")
    if rx.num_channels != SLOTS or rx.plan.wide.any():
        raise AssertionError("receiver: the plan is not 1023 single bins")
    step = rx.build()
    _reset_launches()
    state = rx.init_state()
    outs = []
    for i, x in enumerate(xs):
        if i == RECEIVER_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out, state = step(x, state)
        outs.append(out)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _read_launches()
    want = {e: total if e in ("dqpsk", "channelize") else 0
            for e in _ENTRY_KEYS}
    if launches != want:
        raise AssertionError(f"receiver: launches {launches}, expected "
                             f"{want}")
    msps = M * CHUNK_BLOCKS * RECEIVER_TIMED / elapsed / 1e6

    dynamic = rx.build_dynamic()
    bins = torch.as_tensor(rx.plan.bins, device="cuda")
    step_rad = torch.as_tensor((2.0 * np.pi * rx.plan.offsets / rx.plan.rate)
                               .astype(np.float32), device="cuda")
    d_state = rx.init_state()
    for x, out in zip(xs, outs):
        d_out, d_state = dynamic(x, d_state, bins, step_rad)
        if not all(torch.equal(out[k], d_out[k]) for k in out):
            raise AssertionError("receiver: build() differs from "
                                 "build_dynamic()")
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(d_state))):
        raise AssertionError("receiver: build()'s state differs from "
                             "build_dynamic()'s")

    dibits = [o["dibits"] for o in outs]
    valid = [o["valid"] for o in outs]
    control = {int(m.content.opcode) for m in _framed(dibits, valid, 0)
               if hasattr(m.content, "opcode")}
    voice_rows = [i for i in range(1, SLOTS) if i != TRAFFIC_INDEX]
    sampled = voice_rows[::len(voice_rows) // FRAMED_VOICE_SLOTS]
    framed = sum(bool(_framed(dibits, valid, i)) for i in sampled)
    result = {"card": card, "channels": rx.num_channels,
              "wideband_msps": FS / 1e6,
              "chunk_samples": M * CHUNK_BLOCKS, "timed_chunks":
              RECEIVER_TIMED, "msps": msps, "realtime_factor":
              msps * 1e6 / FS, "wall_ms_per_chunk":
              elapsed * 1e3 / RECEIVER_TIMED,
              "equals_build_dynamic": True,
              "control_opcodes": sorted(control),
              "voice_slots_framed": framed, "voice_slots_sampled":
              len(sampled), "kernel_launches": launches}
    print(f"[receiver] {card}: build() " + json.dumps(result), flush=True)
    # the control channel's TSBKs: IDEN_UP, the grant, RFSS status
    if not {0x3D, 0x00, 0x3A} <= control:
        raise AssertionError(f"receiver: control slot framed {control}")
    if framed < 0.99 * len(sampled):
        raise AssertionError(f"receiver: frames on {framed} of "
                             f"{len(sampled)} sampled voice slots")
    return result


def _twobin(card: str) -> dict:
    """tests/test_twobin.py::test_25khz_nbfm_on_12p5_grid on the card: a
    25 kHz NBFM channel between two 12.5 kHz bins through build() with
    channel_bandwidths; its dominant tone within 20 Hz."""
    import numpy as np
    import torch

    from sdrtrunk_tpu_torch.decoders.nbfm import NBFMConfig, NBFMDecoder
    from sdrtrunk_tpu_torch.receiver import WidebandReceiver
    from sdrtrunk_tpu_torch.signal.generators import nbfm_modulate

    fs, center, tone_hz = 32 * 12500.0, 31250.0, 1100.0
    audio = np.sin(2 * np.pi * tone_hz * np.arange(2000) / 8000)
    iq = nbfm_modulate(audio, 8000, fs, deviation_hz=5000.0)
    n = len(iq) // 32 * 32
    wide = (iq[:n] * np.exp(2j * np.pi * center * np.arange(n) / fs)
            ).astype(np.complex64)
    rx = WidebandReceiver(fs, [center], channel_bandwidths=[25000.0],
                          decoder=NBFMDecoder(NBFMConfig(
                              sample_rate=25000.0, bandwidth=25000.0),
                              device="cuda"), device="cuda")
    out, _ = rx.build()(torch.as_tensor(wide, device="cuda"),
                        rx.init_state())
    got = _dominant_hz(out["audio"][0].cpu().numpy())
    record = {"bins": rx.plan.bins[0].tolist(), "dominant_hz": got}
    print(f"[receiver] {card}: 25 kHz NBFM on two bins " + json.dumps(record),
          flush=True)
    if not rx.plan.wide[0] or abs(got - tone_hz) > 20.0:
        raise AssertionError(f"receiver: two-bin NBFM {record}")
    return record


# tolerances of tests/test_torch_misc_dsp.py, card against CPU
_DSP_TOL = {"oscillate": 1e-6, "mix_down": 1e-5, "fs4_down_convert": 0.0,
            "cic_channel": 1e-5, "goertzel_power": 1e-6, "biquad": 1e-5,
            "cma_equalize": 1e-4, "iq_correction": 1e-5,
            "real_to_complex": 1e-6, "synthesize_two": 1e-5}


# the biquad at the bank's shape (rows of a chunk's channel samples) and
# the CMA equalizer on a QPSK stream through a static channel
BIQUAD_C, BIQUAD_T = KERNEL_C, KERNEL_T
CMA_T = 20000
# the dependent float32 operations of a sample's chain (csrc/biquad.cu,
# csrc/cma.cu: the CMA's tree of four shuffled sums at 11 taps counted as
# its adds), each at least 4 cycles of the SM clock
CHAIN_OPS = {"biquad": 4, "cma": 22}
CHAIN_OP_CYCLES = 4


def _dsp_inputs() -> dict:
    """numpy inputs of the DSP checks, from one seed."""
    import numpy as np

    from sdrtrunk_tpu_torch.dsp import misc

    rng = np.random.default_rng(37)
    z = (rng.standard_normal(96 * 400) + 1j * rng.standard_normal(96 * 400)
         ).astype(np.complex64)
    # QPSK through a mild static channel, which the equalizer converges on
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, CMA_T)))
    qpsk = np.convolve(qpsk, [1.0, 0.25 - 0.1j])[:CMA_T].astype(np.complex64)
    r = rng.standard_normal(3000).astype(np.float32)
    rows = rng.standard_normal((BIQUAD_C, BIQUAD_T)).astype(np.float32)
    b, a = misc.biquad_design("bandpass", 1200.0, 8000.0, q=5.0)
    crows = rng.standard_normal((BIQUAD_C, BIQUAD_T, 2), np.float32)
    return {"z": z, "qpsk": qpsk, "r": r, "rows": rows, "b": b, "a": a,
            "crows": crows.view(np.complex64)[..., 0]}


def _dsp(card: str, inputs: dict) -> dict:
    """The rest of the DSP (dsp/oscillator.py, cic.py, misc.py and
    synthesize_two) once each on CUDA tensors against the same call on the
    CPU, within tests/test_torch_misc_dsp.py's tolerances; the biquad at
    BIQUAD_C x BIQUAD_T and the CMA equalizer on CMA_T samples, one kernel
    launch each."""
    import torch

    from sdrtrunk_tpu_torch.dsp import cic, design, misc, oscillator
    from sdrtrunk_tpu_torch.dsp.synthesizer import synthesize_two

    z, qpsk, r = inputs["z"], inputs["qpsk"], inputs["r"]
    b, a = inputs["b"], inputs["a"]
    hb = design.half_band(22)
    calls = {
        "oscillate": lambda d, t: oscillator.oscillate(
            1234.5, 48000.0, 3000, 0.5, device=d)[0],
        "mix_down": lambda d, t: oscillator.mix_down(
            t(z), 2500.0, 48000.0)[0],
        "fs4_down_convert": lambda d, t: oscillator.fs4_down_convert(t(z)),
        "cic_channel": lambda d, t: cic.CICChannel.design(
            2_400_000.0, 300e3, 25e3, device=d)(t(z))[0],
        "goertzel_power": lambda d, t: misc.goertzel_power(
            t(r), 1000.0, 8000.0),
        "biquad": lambda d, t: misc.biquad_apply(t(inputs["rows"]), b,
                                                 a)[0],
        "cma_equalize": lambda d, t: misc.cma_equalize(t(qpsk),
                                                       mu=0.003)[0],
        "iq_correction": lambda d, t: misc.iq_correction(t(z), 0.005)[0],
        "real_to_complex": lambda d, t: misc.real_to_complex(t(r), hb)[0],
        "synthesize_two": lambda d, t: synthesize_two(
            t(z[:3000]), t(z[3000:6000]))[0],
    }
    errs = {}
    for name, call in calls.items():
        got = {}
        for dev in ("cpu", "cuda"):
            got[dev] = call(dev, lambda a, dev=dev: torch.as_tensor(
                a, device=dev)).cpu()
        if got["cuda"].shape != got["cpu"].shape:
            raise AssertionError(f"receiver: {name} shapes differ")
        errs[name] = float((got["cuda"] - got["cpu"]).abs().max())
    print(f"[receiver] {card}: DSP on the card against the CPU, max abs "
          "err " + json.dumps(errs), flush=True)
    bad = {k: v for k, v in errs.items() if v > _DSP_TOL[k]}
    if bad:
        raise AssertionError(f"receiver: beyond tolerance {bad} "
                             f"({_DSP_TOL})")
    return errs


def _sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    return float(out) * 1e6


def _recurrence_record(card: str, name: str, source: str, replaces: str,
                       kernel, plain, nbytes: int, flops: int,
                       chain_samples: int, shape: list,
                       label: str = "") -> dict:
    """A serial recurrence's kernel against its plain version on the card,
    bit for bit, timed by CUDA events (the kernel over 5 calls, the plain
    loop once) beside its bound: bytes over the memory rate or its float32
    operations over the float32 rate, whichever is longer; and the chain's
    floor beside them, CHAIN_OPS dependent operations a sample at
    CHAIN_OP_CYCLES cycles of the highest SM clock, times the samples of
    one chain."""
    import torch

    got, want = {}, {}

    def run_plain():
        want["out"] = plain()
    plain_ms = _cuda_ms(run_plain)
    got["out"] = kernel()
    kernel_ms = _cuda_ms(kernel, reps=5)
    for what, a, b in zip(("output", "state"), got["out"], want["out"]):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 "plain loop on the card")
    err = max(float((a - b).abs().max()) for a, b in zip(got["out"],
                                                         want["out"]))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = ((by_bytes, "bytes") if by_bytes >= by_ops
                          else (by_ops, "operations"))
    chain_ms = (chain_samples * CHAIN_OPS[name] * CHAIN_OP_CYCLES
                / _sm_clock_hz() * 1e3)
    print(f"[receiver] {card}: {name}{label} {shape}: identical to the "
          f"plain loop "
          f"on the card (output and state); kernel {kernel_ms:.4f} ms "
          f"against a {bound_ms:.4f} ms {bound_by} bound "
          f"({100 * bound_ms / kernel_ms:.2f}% of it) and a {chain_ms:.4f} "
          f"ms chain floor ({100 * chain_ms / kernel_ms:.2f}% of it), plain "
          f"{plain_ms:.1f} ms", flush=True)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "chain_ms": chain_ms, "shape": shape,
            "plain_shape": shape}


def _against_cpu(card: str, name: str, got, cpu, tol: float) -> float:
    """Max abs difference of the card's outputs (output, state) from the
    CPU's plain version; raises beyond tol."""
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, cpu))
    print(f"[receiver] {card}: {name} against the CPU, max abs err {err}",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"receiver: {name} {err} from the CPU, beyond "
                             f"{tol}")
    return err


def check_recurrences(card: str, inputs: dict) -> dict:
    """The biquad at BIQUAD_C x BIQUAD_T float32 and complex64 and the CMA
    equalizer on CMA_T samples at 11 and 32 taps, each kernel against its
    plain version on the card (no PyTorch call computes either: library_ms
    is None); the complex64 rows and the 32 taps, which ``_dsp`` does not
    run, also against the CPU. The complex64 and 32-tap records ride in
    their entry under "complex64" and "taps32"."""
    import torch

    from sdrtrunk_tpu_torch.dsp import misc
    from sdrtrunk_tpu_torch.dsp.biquad_cuda import biquad_cuda
    from sdrtrunk_tpu_torch.dsp.cma_cuda import cma_cuda

    b, a = inputs["b"], inputs["a"]
    biquad = {}
    for dtype in ("float32", "complex64"):
        rows = torch.as_tensor(inputs["rows" if dtype == "float32"
                                      else "crows"], device="cuda")
        c, t = rows.shape
        nbytes = 2 * rows.numel() * rows.element_size() \
            + 2 * c * 2 * rows.element_size()
        biquad[dtype] = _recurrence_record(
            card, "biquad", "sdrtrunk_tpu_torch/csrc/biquad.cu",
            "sdrtrunk_tpu/dsp/misc.py:91",
            lambda rows=rows: biquad_cuda(rows, b, a),
            lambda rows=rows: misc.biquad_apply_plain(rows, b, a), nbytes,
            7 * c * t * (rows.element_size() // 4), t, [c, t], f" {dtype}")
    biquad["complex64"]["cpu_max_abs_err"] = _against_cpu(
        card, "biquad complex64", biquad_cuda(rows, b, a),
        misc.biquad_apply_plain(torch.as_tensor(inputs["crows"]), b, a),
        _DSP_TOL["biquad"])
    x = torch.as_tensor(inputs["qpsk"], device="cuda")
    cma = {}
    for k in (11, 32):
        taps = misc.cma_init(k, device="cuda")
        n = x.shape[0]
        cma[k] = _recurrence_record(
            card, "cma", "sdrtrunk_tpu_torch/csrc/cma.cu",
            "sdrtrunk_tpu/dsp/misc.py:123",
            lambda taps=taps: cma_cuda(x, taps, mu=0.003),
            lambda taps=taps: misc.cma_equalize_plain(x, taps, mu=0.003),
            2 * n * 8 + 2 * k * 8, n * (14 * k + 20), n, [n],
            f" {k} taps")
        cma[k]["taps"] = k
    cma[32]["cpu_max_abs_err"] = _against_cpu(
        card, "cma 32 taps", cma_cuda(x, taps, mu=0.003),
        misc.cma_equalize_plain(x.cpu(), taps.cpu(), mu=0.003),
        _DSP_TOL["cma_equalize"])
    return {"biquad": {**biquad["float32"], "complex64": biquad["complex64"]},
            "cma": {**cma[11], "taps32": cma[32]}}


def run_receiver(card: str) -> dict:
    """The static receiver build at full width, the two-bin NBFM channel
    through it, and the rest of the DSP on the card: its calls counted (a
    launch of the biquad and of the CMA kernel, none of the others), then
    the biquad and the CMA kernels held against their plain versions."""
    result = _static_build(card)
    twobin = _twobin(card)
    inputs = _dsp_inputs()
    _reset_launches()
    dsp = _dsp(card, inputs)
    launches = _read_launches()
    want = {e: int(e in ("biquad", "cma")) for e in _ENTRY_KEYS}
    if launches != want:
        raise AssertionError(f"receiver: DSP launches {launches}, expected "
                             f"{want}")
    return {**result, "twobin": twobin, "dsp": dsp,
            "kernel_launches": {e: n + launches[e] for e, n in
                                result["kernel_launches"].items()},
            "entries": check_recurrences(card, inputs)}


# --- parallel: the sharded channelizer pipeline over torch.distributed ---

PARALLEL_WARMUP, PARALLEL_STREAMED = 1, 4
PARALLEL_TOL = 5e-5              # tests/test_parallel.py's streaming bound
PARALLEL_REPS = 5
HARNESS_TIMEOUT_S = 300


def _harness(card: str) -> dict:
    """``python -m sdrtrunk_tpu_torch.parallel.multiprocess`` at world size
    1 over NCCL on the card, as a process of its own (it owns the default
    group while it runs): its JSON line must say ok and streaming_ok."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / ".scratch") as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "sdrtrunk_tpu_torch.parallel.multiprocess",
             "--device", "cuda", "--world-size", "1", "--rank", "0",
             "--init-method", f"file://{tmp}/pg"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            capture_output=True, text=True, timeout=HARNESS_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"parallel: the harness exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    row = json.loads(lines[-1])
    print(f"[parallel] {card}: harness " + json.dumps(row), flush=True)
    if not (row["ok"] and row["streaming_ok"] and row["backend"] == "nccl"):
        raise AssertionError(f"parallel: the harness failed: {row}")
    return row


def _held(name: str, got, want) -> float:
    """Max |got - want|, 0.0 when bit for bit; raises past PARALLEL_TOL."""
    import torch

    if torch.equal(got, want):
        return 0.0
    err = float((got - want).abs().max())
    print(f"[parallel] {name}: not bit for bit, max |diff| {err}",
          flush=True)
    if not err <= PARALLEL_TOL:
        raise AssertionError(f"parallel: {name} differs from the "
                             f"single-device path by {err}")
    return err


def run_parallel(card: str) -> dict:
    """The sharded pipeline at world size 1 over NCCL: the harness, then
    ShardedChannelizerPipeline in this process at the receiver phase's
    plan (1023 C4FM channels, 12.8 MS/s, M = 1024) on 1 + 4 chunks of 1024
    x 5120 complex64 already on the card, build() on the first and
    build_streaming() over the four, each held against the single-device
    Channelizer + extract_channels; ms a chunk and MS/s by CUDA events
    beside the single-device path's ms and the all_to_all_single's. One
    card gives one rank (NCCL runs one rank a GPU), so the halo ring is
    the degenerate one; the multi-rank path is tested on the CPU over
    gloo. No hand-written kernel runs on this path."""
    import tempfile

    import torch
    import torch.distributed as dist

    from sdrtrunk_tpu_torch.dsp.extract import extract_channels, plan_channels
    from sdrtrunk_tpu_torch.parallel.pipeline import (
        ShardedChannelizerPipeline)

    (ROOT / ".scratch").mkdir(exist_ok=True)
    harness = _harness(card)
    ch, offsets, chunks, _ = _c4fm_scene()
    xs = [(torch.as_tensor(c, device="cuda").float() / 127.0)
          .view(torch.complex64).reshape(-1)
          for c in chunks[:PARALLEL_WARMUP + PARALLEL_STREAMED]]
    plan = plan_channels(ch, offsets)
    _reset_launches()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(dir=ROOT / ".scratch") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                world_size=1, rank=0)
        try:
            pipe = ShardedChannelizerPipeline(ch, plan)
            one_shot = pipe.build()
            y, _ = ch(xs[0])
            want, _ = extract_channels(y, plan)
            got = one_shot(xs[0])
            errs = {"build": _held("build()", got, want)}
            stream, carry = pipe.build_streaming(), pipe.init_carry()
            state, phase = ch.init_state(), None
            for j, x in enumerate(xs[PARALLEL_WARMUP:]):
                got, carry = stream(x, carry)
                y, state = ch(x, state)
                want, phase = extract_channels(y, plan, phase)
                errs[f"streaming chunk {j}"] = _held(
                    f"build_streaming() chunk {j}", got, want)
            x = xs[0]
            pipe_ms = _cuda_ms(lambda: one_shot(x), PARALLEL_REPS)
            single_ms = _cuda_ms(lambda: extract_channels(ch(x)[0], plan),
                                 PARALLEL_REPS)
            send = torch.view_as_real(got.reshape(1, *got.shape))
            recv = torch.empty_like(send)
            a2a_ms = _cuda_ms(lambda: dist.all_to_all_single(recv, send),
                              PARALLEL_REPS)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    launches = _read_launches()
    # the channelizer once a call: build() and ch() on the first chunk,
    # build_streaming() and ch() on each streamed one, the timed calls
    calls = 2 * (1 + PARALLEL_STREAMED + PARALLEL_REPS)
    if launches != {e: calls * (e == "channelize") for e in _ENTRY_KEYS}:
        raise AssertionError(f"parallel: launches {launches}, expected "
                             f"{calls} of the channelizer and none else")
    n = x.shape[0]
    result = {"card": card, "world_size": 1, "backend": backend,
              "channels": plan.count, "chunk_samples": n,
              "streamed_chunks": PARALLEL_STREAMED, "max_abs_err": errs,
              "bit_for_bit": not any(errs.values()),
              "ms_per_chunk": pipe_ms, "msps": n / pipe_ms / 1e3,
              "realtime_factor": n / pipe_ms / 1e3 / (FS / 1e6),
              "single_device_ms": single_ms,
              "all_to_all_single_ms": a2a_ms,
              "all_to_all_bytes": send.numel() * send.element_size(),
              "harness": harness, "kernel_launches": launches}
    print(f"[parallel] {card}: " + json.dumps(
        {k: v for k, v in result.items() if k != "harness"}), flush=True)
    return result


# --- bench: the port's bench.py ------------------------------------------

BENCH_ITERS = 24                 # bench_torch.py's full-size iterations
SMOKE_TIMEOUT_S = 300


def run_bench(card: str) -> dict:
    """bench_torch.py on the card: its kernel-family smoke (``--smoke``) in
    a subprocess, every family passing, then its two flagship receiver
    legs in this process at full width, ``bench_receiver`` for NBFM and
    C4FM (M = 1024, 1023 channels, chunks of 1024 x 5120, 24 timed
    iterations), their MS/s and ``roofline_nbfm``; each leg launches the
    channelizer once a call, the C4FM leg the DQPSK kernel too."""
    import torch

    import bench_torch

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           "--smoke"], cwd=ROOT, capture_output=True,
                          text=True, timeout=SMOKE_TIMEOUT_S)
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    families = {r["smoke"]: r for r in rows if "smoke" in r}
    print(f"[bench] {card}: bench_torch.py --smoke exit {proc.returncode} "
          f"in {time.perf_counter() - t0:.1f} s: " + json.dumps(families),
          flush=True)
    if proc.returncode or len(families) != 7 \
            or not all(r["ok"] for r in families.values()):
        raise AssertionError(f"bench: --smoke failed (exit "
                             f"{proc.returncode}): {proc.stdout[-1500:]} "
                             f"{proc.stderr[-1500:]}")

    _reset_launches()
    nbfm, rx = bench_torch.bench_receiver("nbfm", M, CHUNK_BLOCKS,
                                          BENCH_ITERS, "audio")
    nbfm_launches = _read_launches()
    c4fm, _ = bench_torch.bench_receiver("c4fm", M, CHUNK_BLOCKS,
                                         BENCH_ITERS, "power_db")
    launches = _read_launches()
    roofline = bench_torch.roofline_nbfm(rx, nbfm["msps"])
    result = {"card": card, "smoke": families, "nbfm": nbfm, "c4fm": c4fm,
              "roofline": roofline, "kernel_launches": launches}
    print(f"[bench] {card}: bench_receiver " + json.dumps(
        {k: result[k] for k in ("nbfm", "c4fm", "roofline")}), flush=True)
    # each leg's steps channelize once a call; the C4FM leg's launch the
    # DQPSK kernel once a call too
    steps = BENCH_ITERS + 1
    want_nbfm = {e: steps * (e == "channelize") for e in _ENTRY_KEYS}
    want = {e: {"dqpsk": steps, "channelize": 2 * steps}.get(e, 0)
            for e in _ENTRY_KEYS}
    if nbfm_launches != want_nbfm or launches != want:
        raise AssertionError(f"bench: launches {nbfm_launches} (NBFM), "
                             f"{launches} (both), expected {want_nbfm}, "
                             f"{want}")
    if not (nbfm["msps"] > 0 and c4fm["msps"] > 0
            and nbfm["channels"] == c4fm["channels"] == SLOTS):
        raise AssertionError(f"bench: {nbfm}, {c4fm}")
    torch.cuda.synchronize()
    return result


# --- reference: the bench banks, the cells and the paths against the JAX
# package ---

REFERENCE_FILE = ROOT / "tests" / "torch_reference" / "banks_1023.json"
CELLS_FILE = ROOT / "tests" / "torch_reference" / "cells_full_width.json"
PATHS_FILE = ROOT / "tests" / "torch_reference" / "paths_full_width.json"
# bank or cell -> (the file that holds its reference digest, bench_torch's
# scene builder, its arguments beyond slots and timed_chunks, the
# kernels-line entries it launches once a chunk); the worker is held to
# c4fm_grant's entry's worker view
REFERENCE_BANKS = {
    "c4fm": (REFERENCE_FILE, "scene_orchestrator_bank", {}, ("dqpsk",)),
    "c4fm_int4": (REFERENCE_FILE, "scene_orchestrator_bank",
                  {"ingest": "int4"}, ("dqpsk",)),
    "dmr": (REFERENCE_FILE, "scene_orchestrator_bank_dmr", {},
            ("dqpsk_dmr",)),
    "p25p2": (REFERENCE_FILE, "scene_orchestrator_bank_p25p2", {},
              ("gardner_p25p2",)),
    "nbfm": (REFERENCE_FILE, "scene_orchestrator_bank_nbfm", {}, ()),
    "ltr": (CELLS_FILE, "scene_bank_ltr", {}, ("bit_timing_ltr",)),
    "mpt1327": (CELLS_FILE, "scene_bank_mpt1327", {}, ("bit_timing_afsk",)),
    "lsm": (CELLS_FILE, "scene_bank_lsm", {}, ("gardner_lsm",)),
    "am": (CELLS_FILE, "scene_bank_am", {}, ()),
    "c4fm_25k": (CELLS_FILE, "scene_bank_c4fm_25k", {}, ("dqpsk_w20",)),
    "c4fm_grant": (PATHS_FILE, "scene_bank_c4fm_grant", {}, ("dqpsk",)),
    "worker": (PATHS_FILE, "scene_bank_worker", {}, ("dqpsk",)),
    "slots_c4fm": (PATHS_FILE, "scene_bank_slots_c4fm", {}, ("dqpsk",)),
    "slots_p25p2": (PATHS_FILE, "scene_bank_slots_p25p2", {},
                    ("gardner_p25p2",)),
    "multibank": (PATHS_FILE, "scene_bank_multibank", {},
                  ("dqpsk", "dqpsk_dmr", "bit_timing_ltr")),
    "c4fm_ppm": (PATHS_FILE, "scene_bank_c4fm_ppm", {}, ("dqpsk",)),
}


def _reference_entry(files: dict, path, bank: str) -> dict:
    """A bank's entry in its reference file; the worker's is c4fm_grant's
    with its worker view as the digest and its worker tolerance."""
    if bank != "worker":
        return files[path][bank]
    entry = files[path]["c4fm_grant"]
    return {**entry, "digest": entry["worker_view"],
            "tolerance": entry["worker_tolerance"]}


def _check_hashes(name: str, hashes: list, want: list, what: str) -> None:
    if hashes != want:
        bad = [j for j, (a, b) in enumerate(zip(hashes, want)) if a != b]
        raise AssertionError(
            f"reference {name}: {len(hashes)} {what} built, {len(want)} in "
            f"the file, {what} {bad} hash differently: the scene's bytes "
            f"are not the reference's")


def run_reference(card: str) -> dict:
    """Each bench bank, cell and path rebuilt on the host from its bytes
    (bench.py's for a bank; ``bench_torch.cell_bytes`` for a cell and a
    path; every chunk's sha256 held to the reference file before it runs),
    run on the card as its bench leg runs (a path's recipe steps
    included, c4fm_ppm's record of its PPM correction too), and its digest
    (a cell's and a path's with its events) held slot by slot to the JAX
    package's within the file's tolerance. The worker
    (``host_process=True``) is held to the reference's own worker's view
    and, field for field, to the port's in-process view but where the
    reference's worker parts from its in-process bank; last, the monitor
    (``monitor --bank`` through the CLI on the main path's bytes as a
    16-bit IQ wave) and the mixed monitor are held to the JAX CLI's files
    and lines (``_reference_monitor``)."""
    import hashlib

    import torch

    import bench_torch

    files = {f: json.loads(f.read_text())["banks"]
             for f in {f for f, *_ in REFERENCE_BANKS.values()}}
    launches = {e: 0 for e in _ENTRY_KEYS}
    result, failed = {"card": card, "banks": {}}, []
    own_view = None
    for bank, (path, builder, kw, entries) in REFERENCE_BANKS.items():
        want = _reference_entry(files, path, bank)
        t0 = time.perf_counter()
        scene = getattr(bench_torch, builder)(
            slots=want["slots"], timed_chunks=want["timed_chunks"], **kw)
        scene_s = time.perf_counter() - t0
        hashes = [hashlib.sha256(c.tobytes()).hexdigest()
                  for c in scene.chunks]
        _check_hashes(bank, hashes, want["digest"]["chunks"], "chunks")
        print(f"[reference] {card}: {bank}: all {len(hashes)} chunk "
              f"hashes match the file (scene built in {scene_s:.1f} s)",
              flush=True)
        try:
            _reset_launches()
            record = bench_torch.run_bank(scene)
            torch.cuda.synchronize()
            got_launches = _read_launches()
            chunks = (scene.warmup + scene.timed_chunks
                      + ("rate_change" in scene.steps))
            expect = {e: chunks * (e in (*entries, "channelize"))
                      for e in _ENTRY_KEYS}
            if got_launches != expect:
                raise AssertionError(f"reference {bank}: kernel launches "
                                     f"{got_launches}, expected {expect}")
            for e, n in got_launches.items():
                launches[e] += n
            if bank == "worker":
                digest = bench_torch.worker_view(scene.orch, scene.chunks)
            else:
                digest = bench_torch.bank_digest(
                    scene.orch, scene.chunks, scene.segments,
                    events="events" in want["digest"], steps=scene.steps)
            status = scene.orch.channel_status()
        finally:
            scene.orch.close()
        held = bench_torch.compare_digests(digest, want["digest"],
                                           want["tolerance"])
        row = {"record": record, "totals (port, reference)": held["totals"],
               "differing_slots": len(held["differing"]),
               "events_equal": held["events_equal"],
               "whole_differing": sorted(held["whole_differing"]),
               **({"rms_rel_max": held["rms_rel_max"]}
                  if "rms_rel_max" in held else {}),
               **({"ppm": held["ppm"]} if "ppm" in held else {}),
               "tolerance": {k: v for k, v in want["tolerance"].items()
                             if k != "why"},
               "within_tolerance": held["ok"]}
        if bank == "c4fm_grant":
            own_view = bench_torch.worker_view(scene.orch, scene.chunks)
        if bank == "worker":
            # the port's worker against its own in-process bank: equal but
            # where the reference's worker departs from its in-process
            # bank, and there as the reference does
            in_process = files[path]["c4fm_grant"]["in_process_view"]
            got_apart = bench_torch.compare_digests(digest, own_view or {},
                                                    {}) if own_view else {}
            want_apart = bench_torch.compare_digests(want["digest"],
                                                     in_process, {})
            apart = {k: got_apart.get(k) for k in ("differing",
                                                   "whole_differing")}
            row["apart_from_in_process (port)"] = apart
            if own_view != in_process or apart != {
                    k: want_apart[k] for k in apart}:
                failed.append("worker (against the in-process port)")
            else:
                print(f"[reference] {card}: worker: equal to the in-process "
                      f"port's c4fm_grant view field for field but where "
                      f"the reference's worker parts from its in-process "
                      f"bank, and there alike: " + json.dumps(apart),
                      flush=True)
        print(f"[reference] {card}: {bank}: " + json.dumps(row), flush=True)
        for d in held["differing"]:
            # the metrics are hashed in the file: the port's own beside
            d["port_metrics"] = status[d["slot"]]["metrics"]
            print(f"[reference] {bank} slot {d['slot']} (port, reference): "
                  + json.dumps({k: v for k, v in d.items() if k != "slot"}),
                  flush=True)
        for field, (a, b) in held["whole_differing"].items():
            print(f"[reference] {bank} {field} (port, reference): "
                  + json.dumps([a, b]), flush=True)
        result["banks"][bank] = {**row, "differing": held["differing"]}
        if not held["ok"]:
            failed.append(bank)
        del scene
    for name in REFERENCE_MONITORS:
        monitor = _reference_monitor(card, name, files[PATHS_FILE][name])
        for e, n in monitor.pop("launches").items():
            launches[e] += n
        result["banks"][name] = monitor
        if not monitor["within_tolerance"]:
            failed.append(name)
    if failed:
        raise AssertionError(f"reference: {failed} outside their tolerance "
                             f"against {sorted(str(f) for f in files)}")
    result["kernel_launches"] = launches
    return result


# the reference file's monitors -> (their inputs' builder in bench_torch,
# the keys of the file's entry it takes, the kernels-line entries they
# launch once a chunk)
REFERENCE_MONITORS = {
    "monitor": ("monitor_inputs", ("slots",), ("dqpsk",)),
    "monitor_mixed": ("mixed_monitor_inputs", (),
                      ("dqpsk", "dqpsk_dmr", "bit_timing_ltr")),
}


def _reference_monitor(card: str, name: str, want: dict) -> dict:
    """``python -m sdrtrunk_tpu_torch.cli monitor ...`` as the reference
    file ran the JAX CLI, in this process on the card: ``monitor`` on the
    main path's bytes (``bench_torch.monitor_inputs``: a playlist of the
    control channel, ``--bank --traffic-slots 1022``, the other settings
    at their defaults) or ``monitor_mixed`` on phase 19's scene
    (``bench_torch.mixed_monitor_inputs``: P25, DMR and LTR control
    channels, ``--traffic-slots 4``, every call as mp2, the P25 bits
    tap), each a 16-bit IQ wave whose sha256 is held to the file's before
    the run. What it wrote (``monitor_digest``) is held to the file's
    (``compare_monitor``: the PLL error within the tolerance's bound, the
    mp2 frames of each call that may differ). Where the file keeps the
    reference's own PCM of each mp2 call (``pcm``), the PCM swap is held
    too (``bench_torch.mp2_swap``, ``compare_mp2_swap``): the port's PCM
    within the tolerance of the reference's, and the reference's PCM
    through the port's encoder on the card within its bound of the
    reference's frames and equal to the same encoder's bytes on the CPU,
    so that a departure is the PCM's or a known one of the encoder's."""
    import shutil

    import numpy as np

    import bench_torch
    from sdrtrunk_tpu_torch import use_device
    from sdrtrunk_tpu_torch.audio import mpeg, recorder

    builder, keys, entries = REFERENCE_MONITORS[name]
    directory = APP_DIR / f"reference_{name}"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        inputs = getattr(bench_torch, builder)(
            directory, **{k: want[k] for k in keys})
        wave_s = time.perf_counter() - t0
        _check_hashes(name, [bench_torch._file_sha(inputs["wave"])],
                      [want["digest"]["wave_sha256"]], "waves")
        print(f"[reference] {card}: {name}: the wave's hash matches the "
              f"file (written in {wave_s:.1f} s)", flush=True)
        with bench_torch.mp2_pcm_kept(recorder) as pcm:
            run = _run_cli(inputs["argv"])
        digest = bench_torch.monitor_digest(run["lines"], inputs["audio"],
                                            inputs["events"], inputs["wave"])
    finally:
        shutil.rmtree(APP_DIR, ignore_errors=True)
    expect = {e: want["chunks"] * (e in (*entries, "channelize"))
              for e in _ENTRY_KEYS}
    if run["launches"] != expect:
        raise AssertionError(f"reference {name}: kernel launches "
                             f"{run['launches']}, expected {expect}")
    held = bench_torch.compare_monitor(digest, want["digest"],
                                       want["tolerance"])
    swap, swap_failed = {}, []
    if "pcm" in want:
        def on_cpu(x):
            with use_device("cpu"):
                return bench_torch.mp2_encode(mpeg, x)
        swap = bench_torch.mp2_swap(
            want["digest"]["calls"], np.load(ROOT / want["pcm"]), pcm,
            lambda x: bench_torch.mp2_encode(mpeg, x), on_cpu)
        swap_failed = bench_torch.compare_mp2_swap(swap, want["tolerance"])
    row = {"chunks": len(digest["metrics"]), "wall_s": run["wall_s"],
           "summary (port)": digest["summary"],
           "calls (port, reference)": [len(digest["calls"]),
                                       len(want["digest"]["calls"])],
           "events (port, reference)": [len(digest["events"]),
                                        len(want["digest"]["events"])],
           "pll_error_hz (port, reference)": [
               digest["pll_error_hz"], want["digest"]["pll_error_hz"]],
           "pll_error_hz_max": held["pll_error_hz_max"],
           **({"bits (port, reference)": [digest.get("bits"),
                                          want["digest"]["bits"]]}
              if "bits" in want["digest"] else {}),
           **({"mp2_frames_differing": held["mp2_frames_differing"],
               "pcm_swap": swap, "pcm_swap_failed": swap_failed}
              if "pcm" in want else {}),
           "tolerance": {k: v for k, v in want["tolerance"].items()
                         if k != "why"},
           "differing": sorted(held["differing"]),
           "within_tolerance": held["ok"] and not swap_failed}
    print(f"[reference] {card}: {name}: " + json.dumps(row), flush=True)
    for field, (a, b) in held["differing"].items():
        print(f"[reference] {name} {field} (port, reference): "
              + json.dumps([a, b])[:4000], flush=True)
    return {**row, "launches": run["launches"]}


# phases a run can name, in the order a run takes them; the environment
# and the build always run
PHASES = ("edges", "bits", "psk", "channelize", "c4fm", "c4fm_25k", "p25p2",
          "lsm", "dmr", "nbfm", "am", "ltr", "mpt1327", "slots",
          "slots_p25p2", "multibank", "worker", "cli", "monitor",
          "monitor_mixed", "parity", "receiver", "parallel", "bench",
          "reference")
_LIVE = {"c4fm": run_c4fm, "c4fm_25k": run_c4fm_25k, "p25p2": run_p25p2,
         "lsm": run_lsm, "dmr": run_dmr, "nbfm": run_nbfm, "am": run_am,
         "ltr": run_ltr,
         "mpt1327": run_mpt1327, "slots": run_slots,
         "slots_p25p2": run_slots_p25p2, "multibank": run_multibank,
         "worker": run_worker, "cli": run_cli, "monitor": run_monitor,
         "monitor_mixed": run_monitor_mixed, "parity": run_parity,
         "receiver": run_receiver, "parallel": run_parallel,
         "bench": run_bench, "reference": run_reference}


def check_shape(card: str, entry: str, c: int, t: int) -> dict:
    """Kernels-line entry `entry`'s kernel held against its plain loop at
    (c, t), as phase 4 holds it at 1023 channels."""
    if entry.startswith("bit_timing_"):
        return check_bit_timing(card, entry.removeprefix("bit_timing_"), c,
                                t)
    name, kind, rate, baud, gain, _ = next(k for k in KERNELS
                                           if k[0] == entry)
    return check_kernel(card, name, kind, rate, baud, gain, t, c)


def main(argv: list[str]) -> int:
    phases = set(argv) or set(PHASES)
    unknown = sorted(phases - set(PHASES))
    if unknown:
        raise ValueError(f"unknown phase(s) {', '.join(unknown)}; the "
                         f"phases are {', '.join(PHASES)}")
    if not (ROOT / "sdrtrunk_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)

    build_kernels()
    entries = {}
    # (entry, C, T) -> (the phase that held it, its record)
    held = {}
    if "edges" in phases:
        check_edges(card)
        check_bit_timing_edges(card)
    if "bits" in phases:
        for which in ("ltr", "afsk", *WIDE_BIT_RATES):
            entry = check_bit_timing(card, which)
            entries[entry["name"]] = {**entry, "launches": None}
            held[(entry["name"], *entry["shape"])] = ("bits", entry)
    if "psk" in phases:
        for k in KERNELS:
            entry = check_kernel(card, *k)
            entries[k[0]] = {**entry, "launches": None}
            held[(k[0], *entry["shape"])] = ("psk", entry)
    if "channelize" in phases:
        entries["channelize"] = {**check_channelize(card), "launches": None}
    for name, run in _LIVE.items():
        if name not in phases:
            continue
        shapes, undo = _kernel_calls()
        try:
            result = run(card)
        finally:
            undo()
        for entry, record in result.get("entries", {}).items():
            entries.setdefault(entry, {**record, "launches": None})
        for shape in sorted(set(shapes)):
            if shape not in held:
                held[shape] = (name, check_shape(card, *shape))
            held_in, record = held[shape]
            entry = entries.setdefault(shape[0], {**record, "launches": None})
            entry.setdefault("holds", []).append({
                "path": name, "held_in": held_in,
                **{k: record[k] for k in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms",
                                          "bound_by")}})
        for entry, n in result["kernel_launches"].items():
            if n:
                record = entries.setdefault(entry, {"name": entry,
                                                    "launches": None})
                by_path = record.setdefault("launches_by_path", {})
                by_path[name] = n
                record["launches"] = sum(by_path.values())
    ran = [p for p in PHASES if p in phases]
    print(f"[done] {'every phase' if len(ran) == len(PHASES) else ', '.join(ran)}"
          f" passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [entries[n] for n in _ENTRY_KEYS
                                  if n in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
