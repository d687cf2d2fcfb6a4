"""The check against a broken timed path: a run whose step is broken
underneath comes out not correct, for each fault a cell can have, and
for a step that stops carrying any one leaf of its state. (The exchange
between chips has no fault here: every cell runs on one card.)"""
import pytest
import torch

from benchmark.tests import tiny

torch.set_num_threads(1)


def _state_unchanged(monkeypatch):
    from benchmark.adapter import System

    real = System.dispatch

    def dispatch(self, dev_iq):
        before = self.orch.state
        out = real(self, dev_iq)
        self.orch.state = before          # the step hands back its input
        return out
    monkeypatch.setattr(System, "dispatch", dispatch)


def _half_batch(monkeypatch):
    """The decoder runs on the first half of the slots only; the other
    half's outputs are zeros and their state stays as it was."""
    from sdrtrunk_tpu_torch.receiver import WidebandReceiver

    real = WidebandReceiver.build_dynamic

    def build_dynamic(self):
        step = real(self)

        def half(x, state, bins, steps):
            out, new = step(x, state, bins, steps)
            h = bins.shape[0] // 2

            def keep_old(a, b):
                if isinstance(a, torch.Tensor) and a.dim() >= 1 \
                        and a.shape[0] == bins.shape[0]:
                    a = a.clone()
                    a[h:] = b[h:]
                return a

            from sdrtrunk_tpu_torch.tree import tree_map
            new["dec"] = tree_map(keep_old, new["dec"], state["dec"])
            out = {k: (torch.cat([v[:h], torch.zeros_like(v[h:])])
                       if v.dim() >= 1 and v.shape[0] == bins.shape[0]
                       else v) for k, v in out.items()}
            return out, new
        return half
    monkeypatch.setattr(WidebandReceiver, "build_dynamic", build_dynamic)


def _answer_altered(monkeypatch):
    """One symbol of every slot altered where the step produces it."""
    from benchmark.adapter import System

    real = System.dispatch

    def dispatch(self, dev_iq):
        out = real(self, dev_iq)
        key = "packed" if "packed" in out else (
            "sym" if "sym" in out else "packed_audio")
        v = out[key].clone()
        if key == "sym":
            row = (v >= 4).int().argmax(dim=1)
            idx = torch.arange(v.shape[0])
            v[idx, row] = v[idx, row] ^ 1
        else:
            v[: v.numel() // 2: 97] ^= 1
        out[key] = v
        return out
    monkeypatch.setattr(System, "dispatch", dispatch)


def _leaf_unchanged(monkeypatch, path: tuple):
    """One leaf of the carried state (``path`` into the state: a front
    key, a decoder key, or a decoder key and a field of its named tuple)
    handed back as it was before each step, the rest carried on."""
    from benchmark.adapter import System

    real = System.dispatch

    def dispatch(self, dev_iq):
        before = self.orch.state
        out = real(self, dev_iq)
        new = dict(self.orch.state)
        if len(path) == 1:
            new[path[0]] = before[path[0]]
        else:
            dec = dict(new["dec"])
            old = before["dec"][path[1]]
            dec[path[1]] = old if len(path) == 2 else \
                dec[path[1]]._replace(**{path[2]: getattr(old, path[2])})
            new["dec"] = dec
        self.orch.state = new
        return out
    monkeypatch.setattr(System, "dispatch", dispatch)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
CELLS = [("c4fm_bank_1023", 12), ("nbfm_bank_1023", 40), ("c4fm_site_31", 12)]
# every leaf of each chain's state that a chunk moves, but the symbol
# loop's detected symbol period, which a chunk moves no farther than the
# float32 loop's own rounding does, so that no limit parts the two and its
# gap is read, not compared; the slots' mixer phase and the two-bin join's
# rotation do not move in these cells (each slot sits at its bin's
# centre, a chunk holds a multiple of 4 channel samples), and their gaps
# are compared exactly
LEAVES = {
    "c4fm": [("chan",), ("dec", "fir"), ("dec", "agc"), ("dec", "power"),
             ("dec", "psk")] + [("dec", "psk", f) for f in (
                 "window", "sampling_point", "pll_phase", "pll_freq",
                 "prev_preceding", "prev_current")],
    "nbfm": [("chan",)] + [("dec", k) for k in (
        "fir", "prev", "power", "deemph", "resamp")]}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload,slots", CELLS)
def test_fault_is_not_correct(monkeypatch, workload, slots, fault):
    FAULTS[fault](monkeypatch)
    res = tiny.measure(tiny.spec(workload, slots=slots))
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("workload,slots,path", [
    (w, n, path) for w, n in CELLS
    for path in LEAVES["nbfm" if w.startswith("nbfm") else "c4fm"]])
def test_leaf_unchanged_is_not_correct(monkeypatch, workload, slots, path):
    _leaf_unchanged(monkeypatch, path)
    res = tiny.measure(tiny.spec(workload, slots=slots))
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
