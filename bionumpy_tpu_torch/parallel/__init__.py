"""Data-parallel steps over a single-process device mesh (the port of
bionumpy_tpu/parallel/): parallel/mesh.py holds the Mesh and its
collectives, the other modules the steps that shard and merge."""
from .mesh import create_mesh, device_count
from .kmer_parallel import (parallel_count_kmers, parallel_composition,
                            sharded_pipeline_step)
from .sparse_parallel import (sharded_sparse_count_step,
                              shard_packed_reads, merge_hash_tables)
from .reductions import (sharded_histogram_step, sharded_sum_and_n_step,
                         sharded_pileup_step)

__all__ = ["create_mesh", "device_count", "parallel_count_kmers",
           "parallel_composition", "sharded_pipeline_step",
           "sharded_sparse_count_step", "shard_packed_reads",
           "merge_hash_tables", "sharded_histogram_step",
           "sharded_sum_and_n_step", "sharded_pileup_step"]
