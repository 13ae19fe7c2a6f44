"""The closing stats lines the launchers print after a mapping run
(``map_fastq`` and ``serve``)."""
from __future__ import annotations


def print_mapper_stats(mapper, totals: dict, file=None) -> None:
    """Closing stats lines of a single-topology run (the single-topology
    part of ``repro.launch.serve._print_mapper_stats``): the unified
    MapperStats accounting, the session plan-cache counters, the arena's
    partition accounting of a sharded index and the index footprint."""
    print(f"filter/affine [single]: {totals['survivors']} "
          f"survivors -> {totals['affine_instances']} affine instances "
          f"(of {totals['padded_affine_instances']} padded), dropped "
          f"send={totals['dropped_send']} affine={totals['dropped_affine']}",
          file=file)
    print(f"plan cache: {mapper.plan_cache_hits} hits / "
          f"{mapper.plan_cache_misses} misses "
          f"(same-size batches reuse compiled executables after warm-up)",
          file=file)
    part = totals.get("partitions")
    if part:                          # shard-routed: the arena's account
        print(f"partitions: routed "
              f"{part['minis_routed_per_partition']} minimizers "
              f"(found {part['minis_found_per_partition']}) over "
              f"{part['chunks_routed']} chunk(s); arena "
              f"{part['arena_bytes']} B, {part['partition_loads']} "
              f"load(s), {part['partition_evictions']} eviction(s), "
              f"{part['h2d_bytes']} B h2d", file=file)
    stor = mapper.index_storage()
    per = stor.get("per_partition")
    breakdown = (" (" + ", ".join(
        f"p{d['partition']}: "
        f"{d['hash_table_bytes'] + d['segments_bytes']}"
        for d in per) + ")" if per else "")
    print(f"index storage: {stor['total_bytes']} B "
          f"(hash {stor['hash_table_bytes']} B + segments "
          f"{stor['materialized_segments_bytes']} B, blowup "
          f"{stor['blowup']:.1f}x){breakdown}", file=file)
