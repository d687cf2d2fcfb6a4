"""Symbol->message layer: bit containers, sync detection, EDAC, framers.

Host-side NumPy equivalents of the reference's bits/, edac/, dsp/symbol/ and
module/decode/*/message layers (SURVEY.md section 2.2). Device code produces
dense dibit/bit arrays; everything here is bit-exact host post-processing.
"""
