"""fastkmer_tpu — exact k-mer counting engine for GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the Spark
reference (maruscia/fastkmer, see SURVEY.md): KMC2-style minimizer-signature
binning and exact canonical k-mer counting, distributed over a GPU device
mesh with shard_map + all-to-all instead of a Spark shuffle.
"""

__version__ = "0.1.0"
