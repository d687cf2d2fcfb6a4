"""The port's state checkpoints (sdrtrunk_tpu_torch/runtime/checkpoint.py)
on the CPU: the cases of tests/test_instrument_checkpoint.py on the port,
and the port's leaf order against ``jax.tree_util``'s.

* Resume is exact: a per-channel decode in two chunks, saved after the
  first and resumed from the file, gives bit for bit what the same two
  chunks give without the save (NBFM audio and gate; C4FM dibits, valid
  and every state leaf), and the NBFM audio equals the one-shot decode's
  within the reference test's 2e-5.
* The fingerprint hashes structure, dtypes and shapes, not values: a
  template of another decoder or another leaf shape is refused, as is a
  file with another leaf count.
* A nested tree of dicts round-trips.
* The leaves are flattened in the JAX package's order (dict keys sorted,
  named-tuple and tuple fields in order): the port's NBFM state after a
  block equals the JAX NBFM decoder's state after the same block, leaf
  for leaf, within the NBFM tolerance of tests/test_torch_per_channel.py
  (1e-4), with equal dtypes and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.decoders.nbfm import NBFMConfig as JNBFMConfig
from sdrtrunk_tpu.decoders.nbfm import NBFMDecoder as JNBFMDecoder
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.decoders.am import AMDecoder
from sdrtrunk_tpu_torch.decoders.c4fm import C4FMDecoder
from sdrtrunk_tpu_torch.decoders.nbfm import NBFMConfig, NBFMDecoder
from sdrtrunk_tpu_torch.runtime.checkpoint import (StateCheckpointError,
                                                   load_state, save_state,
                                                   state_fingerprint)
from sdrtrunk_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

FS = 25000.0
NBFM_TOL = 1e-4


def _nbfm_iq():
    audio_in = np.sin(2 * np.pi * 700.0 * np.arange(3000) / 8000.0)
    return generators.nbfm_modulate(audio_in, 8000.0, FS).astype(np.complex64)


def _nbfm():
    return NBFMDecoder(NBFMConfig(sample_rate=FS, squelch_threshold_db=-120.0),
                       device="cpu")


def test_resume_is_bit_exact(tmp_path):
    iq = torch.as_tensor(_nbfm_iq())
    dec = _nbfm()
    out_full, _ = dec(iq, dec.init_state())
    # split on a whole resampler cycle (25 in -> 8 out)
    half = (len(iq) // 2 // 25) * 25
    out1, st = dec(iq[:half], dec.init_state())
    path = str(tmp_path / "state.npz")
    save_state(path, st, {"position": half})
    restored, meta = load_state(path, dec.init_state())
    assert meta["position"] == half
    out2, st2 = dec(iq[half:], restored)
    plain2, plain_st2 = dec(iq[half:], st)
    for key in ("audio", "audio_gate", "power_db"):
        assert torch.equal(out2[key], plain2[key]), key
    for a, b in zip(tree_leaves(st2), tree_leaves(plain_st2)):
        assert torch.equal(a, b)
    resumed = torch.cat([out1["audio"], out2["audio"]]).numpy()
    full = out_full["audio"].numpy()
    assert abs(len(resumed) - len(full)) <= 2
    n = min(len(resumed), len(full))
    np.testing.assert_allclose(resumed[:n], full[:n], atol=2e-5)


def test_c4fm_resume_is_bit_exact(tmp_path):
    from sdrtrunk_tpu_torch.signal.generators import (c4fm_modulate,
                                                      random_dibits)
    iq = torch.as_tensor(c4fm_modulate(random_dibits(300, seed=3), FS)
                         .astype(np.complex64))
    dec = C4FMDecoder(device="cpu")
    split = 700
    _, st = dec(iq[:split], dec.init_state())
    path = str(tmp_path / "c4fm.npz")
    save_state(path, st)
    restored, _ = load_state(path, dec.init_state())
    for a, b in zip(tree_leaves(restored), tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got, got_st = dec(iq[split:], restored)
    want, want_st = dec(iq[split:], st)
    assert int(want["valid"].sum()) > 100
    for key in ("dibits", "valid"):
        assert torch.equal(got[key], want[key]), key
    for a, b in zip(tree_leaves(got_st), tree_leaves(want_st)):
        assert torch.equal(a, b)


def test_fingerprint_guards_mismatch(tmp_path):
    dec1 = NBFMDecoder(NBFMConfig(sample_rate=25000.0), device="cpu")
    s1 = dec1.init_state()
    path = str(tmp_path / "s.npz")
    save_state(path, s1)
    load_state(path, dec1.init_state())          # same structure: loads
    # another decoder (a structure) and another window length (a shape)
    for other in (AMDecoder(device="cpu").init_state(),
                  {**s1, "fir": torch.zeros(30, dtype=torch.complex64)}):
        assert state_fingerprint(other) != state_fingerprint(s1)
        with pytest.raises(StateCheckpointError, match="fingerprint"):
            load_state(path, other)
    # the values do not enter the fingerprint
    s1["power"] += 3.0
    assert state_fingerprint(s1) == state_fingerprint(dec1.init_state())


def test_leaf_count_mismatch_refused(tmp_path):
    path = str(tmp_path / "short.npz")
    save_state(path, {"a": torch.zeros(3)})
    with np.load(path) as data:
        arrays = dict(data)
    arrays["leaf_0001"] = np.zeros(1, np.float32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(StateCheckpointError, match="leaves"):
        load_state(path, {"a": torch.zeros(3)})


def test_nested_tree_roundtrip(tmp_path):
    state = {"a": torch.arange(5, dtype=torch.float32),
             "b": {"c": torch.zeros((2, 3), dtype=torch.complex64),
                   "d": torch.tensor(7, dtype=torch.int32)},
             "e": (torch.ones(2, dtype=torch.int8), torch.tensor(True))}
    path = str(tmp_path / "n.npz")
    save_state(path, state)
    back, _ = load_state(path, state)
    assert torch.equal(back["b"]["c"], torch.zeros((2, 3),
                                                   dtype=torch.complex64))
    assert int(back["b"]["d"]) == 7 and back["b"]["d"].dtype == torch.int32
    assert isinstance(back["e"], tuple) and bool(back["e"][1])
    assert list(back) == list(state)


def test_leaf_order_is_jax_tree_util_order():
    iq = _nbfm_iq()[:2000]
    jdec = JNBFMDecoder(JNBFMConfig(sample_rate=FS))
    _, jstate = jdec(jnp.asarray(iq), jdec.init_state())
    dec = NBFMDecoder(NBFMConfig(sample_rate=FS), device="cpu")
    _, state = dec(torch.as_tensor(iq), dec.init_state())
    want, _ = jax.tree_util.tree_flatten(jstate)
    got = tree_leaves(state)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=NBFM_TOL, atol=NBFM_TOL)
