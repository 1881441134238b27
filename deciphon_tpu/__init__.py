"""deciphon-tpu: frame-aware protein annotation on GPUs, in JAX.

A ground-up JAX/XLA re-design, with a CUDA kernel for its hot loop, with
the capabilities of
EBI-Metagenomics/deciphon: press HMMER3 protein profiles into frame-aware
(quasi-codon) nucleotide profile databases and scan long, error-prone reads
directly against them with a min-plus (Viterbi) dynamic program.
"""

__version__ = "0.1.0"
