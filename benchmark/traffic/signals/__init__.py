"""Signal kinds of the traffic generator, one module a kind, found by the
``"signal"`` value of a mix's entry (``signals/<kind>.py``). A new kind
is a new module here; the generator is not edited.

Each module exposes two functions:

* ``make(entry, rows, rng, rate, samples, device)``: the part of the mix
  that the entry covers. ``entry`` is the mix's entry (its own keys
  beside ``signal`` and the slot assignment), ``rows`` the slots it
  takes, ``rng`` the run's NumPy generator, ``rate`` the channel sample
  rate (Hz), ``samples`` the channel samples the replay set spans, and
  ``device`` where the rows are made. It draws the part's parameters
  from ``rng``, always in the same order: the generator calls the kinds
  in the order of the mix's entries, so each kind's draws fix the bytes
  of every entry after it. Returns whatever ``fill`` needs.
* ``fill(part, n)``: the part's ``(len(rows), len(n))`` complex128 rows
  of unit-carrier baseband at the float64 channel sample indices ``n``
  (a tensor on the part's device), before the generator's carrier
  offset, phase and channel noise; or None for a kind that adds nothing
  before the channel noise.
"""
