"""Multi-host (multi-process) block runtime.

SURVEY.md section 2.6 / build-plan step 7: the reference is
single-threaded, so this layer is net-new architecture.  The design
follows the standard JAX multi-controller model:

  * every host runs the same program and calls `initialize()`
    (jax.distributed) so all processes see one global device list;
  * the mesh axis is ordered PROCESS-MAJOR: the block axis maps hosts
    outermost, each host's local chips innermost.  Block-parallel
    coding is embarrassingly parallel per device — the ONLY cross-host
    collective is the global-histogram psum (sigma * 4 bytes, e.g.
    4 KB for fold-2), so the cross-host network carries kilobytes while
    the per-device streams stay local (within a host the cards reduce
    over NVLink through NCCL).  This is the ">= 80% scaling"
    design point: per-chip throughput is independent of D, and the
    shared-model reduction is latency-, not bandwidth-bound;
  * data stays process-local: `encode_local` takes the HOST'S shard of
    the value stream and returns the HOST'S container shard (plus the
    replicated model prelude).  No host ever materializes the global
    array — the production pattern for sharded storage.  A rank-0
    gather (`gather_container`) assembles the single-file ATFB
    container when one artifact is wanted.

Single-process fallbacks make every entry point runnable (and tested)
on one host; tests/test_multihost.py also spawns a real 2-process
gloo/TCP cluster on the CPU backend to exercise the cross-process
paths end-to-end.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from .block_runtime import BlockCodec


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process
    (so the same driver script runs on one host and on a cluster)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "blocks") -> Mesh:
    """1-D mesh over ALL devices (every process), process-major so the
    block axis crosses the host network only at host boundaries."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def local_block_slice(n_global: int) -> tuple[int, int]:
    """[start, stop) of this process's element range when a length-
    n_global stream is split evenly over processes (same convention as
    BlockCodec's per-device split, one level up)."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n_global // p)
    return min(i * per, n_global), min((i + 1) * per, n_global)


class MultiHostBlockCodec:
    """Process-local facade over BlockCodec for multi-controller runs.

    Every process encodes ITS slice over ITS local devices; the shared
    model is still global: the histogram is reduced over every process,
    so all processes derive byte-identical preludes and
    the shards concatenate into one decodable stream.
    """

    def __init__(self, method: str = "ANSfold-2", lanes: int | None = None):
        self.method = method
        # per-process runtime over the LOCAL devices only; the global
        # model reduction happens in _global_hist below
        local = [d for d in jax.devices()
                 if d.process_index == jax.process_index()]
        self.codec = BlockCodec(method,
                                Mesh(np.array(local), ("blocks",)),
                                lanes=lanes)

    def _global_hist(self, hist_local: np.ndarray) -> np.ndarray:
        """Cross-process allreduce of the local histogram (the one
        cross-host collective; kilobytes)."""
        if jax.process_count() == 1:
            return hist_local
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(
            hist_local)).sum(axis=0)

    def _global_cap(self, local_max: int) -> int:
        """Cross-process max of the per-shard value maxima (a second
        tiny fixed-shape cross-host collective) — uncapped kinds (ANS/sint)
        size the histogram by the data, and the allgathered histograms
        must have ONE global shape."""
        if jax.process_count() == 1:
            return local_max + 1
        from jax.experimental import multihost_utils
        allmax = np.asarray(multihost_utils.process_allgather(
            np.array([local_max], dtype=np.int64)))
        return int(allmax.max()) + 1

    def encode_local(self, values_local) -> bytes:
        """Encode this process's slice into its container shard.  The
        shared model comes from the GLOBAL histogram so shards agree.

        Every process must pass a NON-EMPTY shard: all processes enter
        the same collectives, and an empty shard has no defined local
        maximum (split the stream with local_block_slice, which never
        produces empty shards for n_global >= process_count)."""
        values_local = np.ascontiguousarray(values_local, dtype=np.uint32)
        if len(values_local) == 0:
            # fail clearly BEFORE the collectives (a zero-size .max()
            # ValueError here would leave peer processes blocked in the
            # allgather with no indication why)
            raise ValueError(
                "encode_local requires a non-empty local shard on every "
                "process (this one got 0 values)")
        kind = self.codec.kind
        cap = self.codec._sigma_cap or self._global_cap(
            int(values_local.max()))
        reorder_header = None
        if kind == "rfold":
            # the top-2^(f+7) reorder permutation must be GLOBAL: derive
            # it on every process from the allreduced raw-value
            # histogram (deterministic given counts — same (-count, sym)
            # order as the reference's craft_reorder), then remap the
            # local shard before the fold map/hist pass below
            from ..reference_model.mappings import craft_reorder_from_counts
            raw_cap = self._global_cap(int(values_local.max()))
            raw_hist = self._global_hist(
                np.bincount(values_local, minlength=raw_cap)
                .astype(np.int64))
            mapping, reorder_header = craft_reorder_from_counts(
                raw_hist, self.codec.fidelity)
            if mapping is not None:
                values_local = mapping[values_local]
        # ONE local map+hist pass through the per-process mesh program;
        # the map outputs are handed to encode() so it is not re-run
        D = self.codec.mesh.devices.size
        B = -(-len(values_local) // D)
        vals = np.zeros(D * B, dtype=np.uint32)
        vals[: len(values_local)] = values_local
        mapped, k, b, hist = self.codec._map_hist_program(cap)(
            vals.reshape(D, B))
        hist = np.asarray(hist).astype(np.int64).copy()
        if D * B > len(values_local):
            # remove this shard's zero-padding counts before the
            # cross-process reduction
            hist[self.codec._padding_symbol()] -= D * B - len(values_local)
        hist = self._global_hist(hist)
        # pad the global hist to the cap so encode()'s sigma_cap (=
        # len(hist_override)) matches the cap the map pass used
        if len(hist) < cap:
            hist = np.pad(hist, (0, cap - len(hist)))
        return self.codec.encode(values_local, hist_override=hist,
                                 premapped=(mapped, k, b),
                                 reorder_header=reorder_header)

    def decode_local(self, shard: bytes, n_local: int) -> np.ndarray:
        return self.codec.decode(shard, n_local)


def gather_container(shard: bytes) -> list[bytes] | None:
    """All-gather the per-process shards; returns the ordered list on
    every process (rank order = stream order), or the single shard
    unchanged when single-process."""
    if jax.process_count() == 1:
        return [shard]
    from jax.experimental import multihost_utils
    arr = np.frombuffer(shard, dtype=np.uint8)
    sizes = np.asarray(multihost_utils.process_allgather(
        np.array([len(arr)], dtype=np.int64))).reshape(-1)
    pad = int(sizes.max())
    buf = np.zeros(pad, dtype=np.uint8)
    buf[: len(arr)] = arr
    allb = np.asarray(multihost_utils.process_allgather(buf))
    return [allb[i, : sizes[i]].tobytes() for i in range(len(sizes))]
