"""The benchmark's plain reference: straightforward PyTorch, written from the
algorithm (the reference renderer's NDC camera, CUDA-model texture taps,
clamped LUT, front-to-back "over" with the opacity cutoff, the histogram
decodes, the shear-warp factorization and the uint8 pack).

It imports nothing of the program under test and takes nothing the
program made: the benchmark hands it the same seeded inputs, and it works
out every derived array again. Each routine takes a ``dtype``: float32 is
the reference, bfloat16 the control that computes the same one precision
lower.
"""
