"""The benchmark's one contact with the program: ``sdrtrunk_tpu_torch``'s
``Orchestrator`` built from a configuration, its slots tuned to a replay
set, and the three stages of its live device step as ``run()``
pipelines them (``_prepare``, ``_upload``, ``_dispatch``), the outputs'
download, and, for the traced run, each layer of the step alone.

The program's private names this file uses, the benchmark's contract with
the program: ``Orchestrator._prepare``, ``_upload``, ``_dispatch``,
``_activate``, ``_bank_cap``, ``state``, ``bins`` and ``steps`` (the
slots' plan: each slot's bin pair, equal for one bin, and float32
residual mixer step, held against ``check.slot_front`` at set-up),
``rx``, ``bank_mode``, ``audio_format``, ``decoder_name``; the receiver's
``channelizer.hmat``, ``rot4`` and ``decoder`` (``_front``,
``demod.batched``, ``_resample``); and the module functions ``ingest``,
``channelize_core``, ``dynamic_select_mix``, ``compact_and_correlate``,
``sync_patterns``, ``pack_audio`` and ``pack_sym``. Nothing else of
the benchmark imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

from .check import slot_front


class System:
    """The system under test for one configuration and replay set."""

    def __init__(self, config: dict, replay, device):
        from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
        from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

        dec = config["decoder"]
        center = config["center_frequency_hz"]
        offsets = replay.offsets_hz
        kw = {}
        if "audio_format" in dec:
            kw["audio_format"] = dec["audio_format"]
        self.orch = Orchestrator(
            lambda n: None, config["sample_rate_hz"], center,
            [float(offsets[0])], slots=len(offsets), decoder=dec["kind"],
            channel_bandwidth=config["channel_bandwidth_hz"],
            chunk_samples=replay.chunk_samples,
            idle_teardown_seconds=1e12, ppm_correction=config["ppm_correction"],
            device=device, **kw)
        for off in offsets[1:]:
            self.orch._activate(center + float(off), IdentifierCollection())
        tuned = [s.frequency_hz - center for s in self.orch.slots]
        if not np.allclose(tuned, offsets) or \
                not all(s.active for s in self.orch.slots):
            raise RuntimeError("the orchestrator did not tune the slots in "
                               "the replay set's order")
        _same_front(self.orch, *slot_front(config, replay))
        self.tier = "bank" if self.orch.bank_mode else "slot"
        self.slots = len(offsets)
        self.device = torch.device(device)

    # --- the live device step, as run() pipelines it -------------------

    def prepare(self, iq: np.ndarray):
        return self.orch._prepare(iq)

    def upload(self, prepared):
        return self.orch._upload(prepared)

    def dispatch(self, dev_iq) -> dict:
        return self.orch._dispatch(dev_iq)[0]

    @staticmethod
    def download(out: dict) -> dict:
        """The step's outputs on the host, as NumPy arrays."""
        return {key: v.cpu().numpy() for key, v in out.items()}

    # --- what the judge and the traced run read -------------------------

    def snapshot(self) -> dict:
        """A device copy of the carried state, flattened: each leaf of the
        front (the channelizer's input history ``chan``, the slots'
        ``mixer_phase``, the two-bin join's ``rot``, and any other) under
        its own name, and each leaf of the decoder state under its own (a
        named tuple's fields under theirs)."""
        st = self.orch.state
        flat = {key: v.clone() for key, v in st.items() if key != "dec"}
        for key, v in st["dec"].items():
            if hasattr(v, "_fields"):
                flat.update((f, a.clone()) for f, a in zip(v._fields, v))
            else:
                flat[key] = v.clone()
        return flat

    @staticmethod
    def lanes(snap: dict, slots) -> dict:
        """A snapshot on the host in float64 / complex128, the per-slot
        leaves at ``slots`` (every leaf but ``chan`` and ``rot``)."""
        out = {}
        for key, v in snap.items():
            if key not in ("chan", "rot"):
                v = v[torch.as_tensor(slots, device=v.device)]
            v = v.cpu()
            out[key] = (v.to(torch.complex128) if v.is_complex()
                        else v.to(torch.float64)).numpy()
        return out

    def layers(self, iq8: np.ndarray) -> list:
        """(name, fn) of each layer of the step on one chunk, from a copy
        of the running state: ingest + channelizer, select + mix, then the
        decoder chain's layers and the tier's packing. Each fn reads the
        outputs of the layer before it from a shared dict."""
        from sdrtrunk_tpu_torch.dsp.channelizer import channelize_core
        from sdrtrunk_tpu_torch.receiver import dynamic_select_mix
        from sdrtrunk_tpu_torch.runtime.orchestrator import (
            compact_and_correlate, ingest, pack_audio, pack_sym,
            sync_patterns)

        orch = self.orch
        rx = orch.rx
        dev = rx.channelizer.hmat.device
        state = _clone(orch.state)
        bins = torch.as_tensor(orch.bins, dtype=torch.long, device=dev)
        steps = torch.as_tensor(orch.steps, device=dev)
        x = torch.as_tensor(iq8, device=dev)
        dec = rx.decoder
        dstate = state["dec"]
        r = {}

        def channelize():
            xc = torch.view_as_complex(ingest(x).contiguous())
            r["y"] = channelize_core(torch.cat([state["chan"], xc]),
                                     rx.channelizer.hmat)

        def select_mix():
            r["streams"], _ = dynamic_select_mix(
                r["y"], state["rot"], state["mixer_phase"], bins, steps,
                rx.rot4)

        layers = [("channelize", channelize), ("select_mix", select_mix)]
        if hasattr(dec, "demod"):
            def c4fm_front():
                (r["leveled"], _), _ = dec._front(r["streams"], dstate)

            def dqpsk():
                r["dibits"], r["valid"], _ = dec.demod.batched(
                    r["leveled"], dstate["psk"])

            def compact():
                if orch.bank_mode:
                    compact_and_correlate(r["dibits"], r["valid"],
                                          orch._bank_cap,
                                          *sync_patterns(orch.decoder_name))
                else:
                    pack_sym(r["dibits"], r["valid"])

            return layers + [("c4fm_front", c4fm_front), ("dqpsk", dqpsk),
                             ("compact", compact)]

        def nbfm_chain():
            audio, gate, _, _ = dec._front(r["streams"], dstate)
            r["audio"], r["gate"] = dec._resample(audio, gate,
                                                  dstate["resamp"])

        def pack():
            pack_audio(r["audio"], r["gate"], orch.audio_format)

        return layers + [("nbfm_chain", nbfm_chain), ("pack_audio", pack)]

    def close(self) -> None:
        self.orch.close()
        self.orch = None


def _same_front(orch, pairs: np.ndarray, steps: np.ndarray) -> None:
    """Raise, naming the first slot, where the orchestrator's bins and
    steps are not the slots' front as the check takes it: its pair (both
    the slot's bin for one bin) and the float32 rounding of its step."""
    steps = steps.astype(np.float32)
    bad = np.flatnonzero((np.asarray(orch.bins) != pairs).any(axis=1)
                         | (np.asarray(orch.steps) != steps))
    if bad.size:
        i = int(bad[0])
        raise RuntimeError(
            f"slot {i} ({bad.size} in all): the orchestrator tuned bins "
            f"{orch.bins[i].tolist()}, step {float(orch.steps[i])!r}; the "
            f"check's front has bins {pairs[i].tolist()}, step "
            f"{float(steps[i])!r}")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_clone(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree
