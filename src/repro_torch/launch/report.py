"""The closing stats lines the launchers print after a mapping run
(``map_fastq`` and ``serve``)."""
from __future__ import annotations


def print_mapper_stats(mapper, totals: dict, file=None) -> None:
    """Closing stats lines (``repro.launch.serve._print_mapper_stats``):
    the unified MapperStats accounting under the label of the stage that
    ran it (the mesh's stage B or the single topology's filter/affine
    stages), the session plan-cache counters, the partition accounting of
    a sharded index (the arena's when shard-routed, the mesh placement's
    on the mesh) and the index footprint."""
    label = ("stage B [mesh]" if mapper.topology == "mesh"
             else "filter/affine [single]")
    print(f"{label}: {totals['survivors']} "
          f"survivors -> {totals['affine_instances']} affine instances "
          f"(of {totals['padded_affine_instances']} padded), dropped "
          f"send={totals['dropped_send']} affine={totals['dropped_affine']}",
          file=file)
    print(f"plan cache: {mapper.plan_cache_hits} hits / "
          f"{mapper.plan_cache_misses} misses "
          f"(same-size batches reuse compiled executables after warm-up)",
          file=file)
    part = totals.get("partitions")
    if part:
        if "minis_routed_per_partition" in part:  # shard-routed single
            print(f"partitions: routed "
                  f"{part['minis_routed_per_partition']} minimizers "
                  f"(found {part['minis_found_per_partition']}) over "
                  f"{part['chunks_routed']} chunk(s); arena "
                  f"{part['arena_bytes']} B, {part['partition_loads']} "
                  f"load(s), {part['partition_evictions']} eviction(s), "
                  f"{part['h2d_bytes']} B h2d", file=file)
        else:  # mesh: partition i on shard i
            print(f"partitions: {part['num_partitions']} mesh-placed, "
                  f"occurrences {part['occurrences_per_partition']}, "
                  f"stage-B survivors {part['survivors_per_partition']}",
                  file=file)
    stor = mapper.index_storage()
    if stor is not None:          # None: a session on a bare ShardedIndex
        per = stor.get("per_partition")
        breakdown = (" (" + ", ".join(
            f"p{d['partition']}: "
            f"{d['hash_table_bytes'] + d['segments_bytes']}"
            for d in per) + ")" if per else "")
        print(f"index storage: {stor['total_bytes']} B "
              f"(hash {stor['hash_table_bytes']} B + segments "
              f"{stor['materialized_segments_bytes']} B, blowup "
              f"{stor['blowup']:.1f}x){breakdown}", file=file)
