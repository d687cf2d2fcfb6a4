"""Plain reference of the live device step, one module a decoder kind.

A module whose kind the program serves from two adjacent channelizer
bins states ``SLOT_FRONT = "bin_pair"``; without it a slot is one bin
(``check.slot_front``)."""
