"""Analytic GEMM model — the GEMM half of the JAX package's
``runtime/perf_model.py``, re-derived for the H100.

A roofline: ``max(flops / peak, bytes / HBM rate)``, with the operand dims
quantized up to the tensor cores' tile and the peak taken for the operand
type (the H100 runs fp8 at twice bf16's rate and fp32 outside the tensor
cores at a fifteenth of it). It ranks kernel B3's tile candidates for the
contextual autotuner (:func:`rank_gemm_tiles`) so only the top few are
measured.

The communication half (:func:`allreduce_time_s` and its parts) feeds the
collectives' AUTO selectors (``ops/allreduce.get_auto_allreduce_method``,
``ops/allgather.get_auto_all_gather_method``) and ``layers/tp_mlp.
pick_mode``. It is the reference's ICI model on the H100's NVLink: a
rank pushes at ``link_gbps`` a direction, shared by its peers, and pays
``link_latency_s`` a hop. An NVLink host joins its cards all to all
(NVSwitch), so every peer is one hop away — where the reference walks a
torus ring, the port's hop counts are 1.

The constants are published peaks (NVIDIA's H100 SXM data sheet, dense,
at the 700 W power limit); the model ranks, so ±20% error in them is
harmless. The inter tier of a two-tier (dcn, tp) group —
:func:`dcn_collective_time_s` and the 2-D fused estimates that
``layers/tp_mlp.pick_mode`` reads for its ``"overlap2d"`` candidate — is
charged at one InfiniBand port a card (``ChipSpec.dcn_gbps``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

from triton_distributed_tpu_torch.runtime.utils import round_up


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Roofline parameters of one card."""

    name: str
    bf16_tflops: float       # dense tensor-core peak
    fp8_tflops: float
    fp32_tflops: float       # CUDA cores (FMA), no TF32
    hbm_gbps: float          # device memory, GB/s
    smem_bytes: int          # shared memory one block can use
    sm_count: int
    # Rows and columns of the tensor cores' tile (wgmma's M): a (65, k)
    # product pays for (128, k) in the model.
    tc_tile: int = 64
    # Sustained share of the peak a well-tiled GEMM reaches; ranking only
    # needs it to be the same for every tile.
    gemm_efficiency: float = 0.6
    # One card's NVLink to a peer, per direction, GB/s, and a hop's
    # latency: what a cross-card push is charged (the reference's ICI link
    # parameters).
    link_gbps: float = 450.0
    link_latency_s: float = 1e-6
    # The inter tier of a two-tier group (the reference's DCN; here the
    # network between H100 hosts): one NDR InfiniBand port a card, 400
    # Gb/s = 50 GB/s a direction (NVIDIA DGX H100: eight ConnectX-7 NDR
    # ports, one a GPU), and a hop's latency for one RDMA write and its
    # flag through the network: a guess, neither measured nor taken from a
    # published figure. It sets AUTO's "overlap2d" crossover, which
    # ``scripts/dcn_crossover.py`` shows at half and twice this value. No
    # TPU DCN number is used.
    dcn_gbps: float = 50.0
    dcn_latency_s: float = 5e-6

    def peak_tflops(self, itemsize: int) -> float:
        """The peak for an operand type of ``itemsize`` bytes."""
        return {1: self.fp8_tflops, 2: self.bf16_tflops}.get(
            itemsize, self.fp32_tflops)


# Peak rates and sizes from the H100 SXM data sheet.
_SPECS = {
    "h100": ChipSpec("h100", 989.0, 1979.0, 67.0, 3350.0, 232448, 132),
}

# Kernel B3's routes (ops/gemm.ROUTES): the share of the peak (operations,
# bytes) each reaches, which ranks the tuner's candidates across routes.
# Read on an H100 80GB HBM3 at 700 W (PERF.md row 3): "mma" and "fma" are
# the register-staged tiles at the headline 2048 x 5120 x 5120 (bf16 87
# TFLOP/s = 8.8% of 989; fp32 4.549 ms against the 1.603 bound = 35%) and
# at m = 8 (bf16 0.0621 ms against the 0.0157 byte bound = 25%); "wgmma"
# the headline on the wgmma route (bf16 0.164 ms against 0.1086 = 66%;
# e4m3 with its B^T pre-pass 0.133 against 0.0543 = 41%); "splitk" the
# M = 1 e4m3 decode products (w_gate/w_up and w_down 0.026 ms against
# 0.0150 = 58%, wq/wo 38%) — its mma.sync never bounds it at <= 16 rows.
ROUTE_EFFICIENCY = {"mma": (0.088, 0.25), "fma": (0.35, 0.25),
                    "wgmma": (0.6, 0.6), "splitk": (0.3, 0.55)}
# The wgmma route's time for one pair tile (two 128-row tiles) at each
# width, in units of the 128-column one: what ``ops/gemm.select_tile``
# weighs against the last wave's fill. The bf16 headline took 162.7 us in
# 3 waves of 128 x 256 pair tiles and 176.3 in 5 of 128 x 128 (the H100
# above): 54.2 / 35.3 = 1.54.
WGMMA_TILE_TIME = {128: 1.0, 256: 1.54}

# CPU fallback: arbitrary but self-consistent, so ranking logic and the
# tests behave; never used on the card.
_FALLBACK = ChipSpec("generic", 100.0, 200.0, 10.0, 800.0, 48 << 10, 16)


def chip_spec(kind: str | None = None) -> ChipSpec:
    """Spec for a device name (default: ``torch.cuda.get_device_name()``,
    or ``"cpu"`` without CUDA)."""
    if kind is None:
        kind = _default_device_kind()
    k = kind.lower()
    for tag, spec in sorted(_SPECS.items(), key=lambda kv: -len(kv[0])):
        if tag in k:
            return spec
    return _FALLBACK


@functools.lru_cache(maxsize=1)
def _default_device_kind() -> str:
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def gemm_time_s(m: int, n: int, k: int, itemsize: int,
                spec: ChipSpec | None = None) -> float:
    """Roofline time of an (m, k) @ (k, n) product: tile-quantized compute
    at the type's peak vs each operand and the output moved once."""
    spec = spec or chip_spec()
    mq, nq, kq = (round_up(max(int(d), 1), spec.tc_tile) for d in (m, n, k))
    flops = 2.0 * mq * nq * kq
    t_compute = flops / (spec.peak_tflops(itemsize) * 1e12
                         * spec.gemm_efficiency)
    bytes_moved = (m * k + k * n + m * n) * itemsize
    t_memory = bytes_moved / (spec.hbm_gbps * 1e9)
    return max(t_compute, t_memory)


def gemm_tflops(m: int, n: int, k: int, itemsize: int,
                spec: ChipSpec | None = None) -> float:
    """Achievable TFLOP/s for the (m, n, k) problem under the model."""
    return 2.0 * m * n * k / gemm_time_s(m, n, k, itemsize, spec) / 1e12


def rank_gemm_tiles(candidates, m: int, n: int, k: int, itemsize: int,
                    spec: ChipSpec | None = None, top: int | None = None,
                    routes: dict | None = None):
    """Rank (tile_m, tile_n, tile_k) configs by modeled time, best first.

    Each tile is charged its padding waste (ragged edges run whole tiles)
    and the traffic of re-reading B for every row of tiles and A for every
    column of tiles. The two terms are summed, not maxed: with the max
    every tile under the compute roof ties and the ranking degenerates to
    list order. A tile that fills fewer blocks than the card has SMs is
    charged for the idle SMs. ``routes`` ({tile: B3 route}, e.g.
    ``ops.gemm.tile_routes(lane)``) scales each term by its route's
    :data:`ROUTE_EFFICIENCY`; without it every tile gets
    ``spec.gemm_efficiency``. The persistent routes (wgmma, split-K) fill
    the card whatever their tile count."""
    spec = spec or chip_spec()

    def score(cfg) -> float:
        tm, tn, tk = cfg
        route = (routes or {}).get(tuple(cfg))
        eff_c, eff_b = ROUTE_EFFICIENCY.get(
            route, (spec.gemm_efficiency, 1.0))
        n_m, n_n, n_k = math.ceil(m / tm), math.ceil(n / tn), math.ceil(k / tk)
        flops = 2.0 * (n_m * tm) * (n_n * tn) * (n_k * tk)
        fill = (1.0 if route in ("wgmma", "splitk")
                else min(1.0, n_m * n_n / spec.sm_count))
        t_compute = flops / (spec.peak_tflops(itemsize) * 1e12
                             * eff_c * fill)
        reread = 1 if route == "splitk" else n_m
        bytes_moved = (reread * k * n + n_n * m * k + m * n) * itemsize
        t_memory = bytes_moved / (spec.hbm_gbps * 1e9 * eff_b * fill)
        return t_compute + t_memory

    ranked = sorted(candidates, key=score)
    return ranked[:top] if top else ranked


# ---------------------------------------------------------------------------
# Collective cost models. nbytes is the GLOBAL payload (the whole gathered
# or reduced tensor), n the ranks of the group.
# ---------------------------------------------------------------------------

def _mean_ring_hops(n: int) -> float:
    """Mean hops from a rank to its n-1 peers. The reference's torus ring
    gives 4/3 at n = 4; on an all-to-all NVLink host every peer is one
    hop away, so it is 1 (0 alone)."""
    return 0.0 if n <= 1 else 1.0


def _far_hops(n: int) -> int:
    """Hops to the farthest peer: 1 on an all-to-all NVLink host (the
    reference's ring has n // 2)."""
    return 1


def _link_bw(spec: ChipSpec) -> float:
    """Bytes/s one rank can push (its NVLink egress, one direction)."""
    return spec.link_gbps * 1e9


def allgather_ring_time_s(nbytes: int, n: int,
                          spec: ChipSpec | None = None) -> float:
    """1-D ring AG: n-1 steps, each forwarding one shard one hop."""
    spec = spec or chip_spec()
    if n <= 1:
        return 0.0
    shard = nbytes / n
    return (n - 1) * (shard / _link_bw(spec) + spec.link_latency_s)


def allgather_full_mesh_time_s(nbytes: int, n: int,
                               spec: ChipSpec | None = None) -> float:
    """Full-mesh push AG: every rank pushes its shard to its n-1 peers at
    once, sharing its egress; the latency is paid once, for the farthest
    peer."""
    spec = spec or chip_spec()
    if n <= 1:
        return 0.0
    shard = nbytes / n
    return ((n - 1) * shard * _mean_ring_hops(n) / _link_bw(spec)
            + _far_hops(n) * spec.link_latency_s)


def reduce_scatter_ring_time_s(nbytes: int, n: int,
                               spec: ChipSpec | None = None) -> float:
    """Ring RS mirrors ring AG step for step (the adds are free)."""
    return allgather_ring_time_s(nbytes, n, spec)


def allreduce_time_s(nbytes: int, n: int, method: str = "two_shot",
                     spec: ChipSpec | None = None,
                     tree_halves: int = 2) -> float:
    """AR cost: ``one_shot`` — every rank pushes the WHOLE payload to its
    n-1 peers; ``two_shot`` — ring RS + ring AG; ``tree`` — the double
    binary tree, 2 ceil(log2 n) hops of a half payload
    (``tree_halves=1``: one tree of the whole payload)."""
    spec = spec or chip_spec()
    if n <= 1:
        return 0.0
    if method == "one_shot":
        return ((n - 1) * nbytes * _mean_ring_hops(n) / _link_bw(spec)
                + _far_hops(n) * spec.link_latency_s)
    if method == "two_shot":
        return (reduce_scatter_ring_time_s(nbytes, n, spec)
                + allgather_ring_time_s(nbytes, n, spec))
    if method == "tree":
        depth = max(1, math.ceil(math.log2(n)))
        half = nbytes / max(tree_halves, 1)
        return 2 * depth * (half / _link_bw(spec) + spec.link_latency_s)
    raise ValueError(f"unknown allreduce method {method!r}")


def ag_gemm_time_s(m_global: int, n_cols: int, k: int, n_ranks: int,
                   itemsize: int, spec: ChipSpec | None = None) -> float:
    """Overlapped AG+GEMM ~ max(comm, compute) + one chunk's fill."""
    spec = spec or chip_spec()
    t_gemm = gemm_time_s(m_global, n_cols, k, itemsize, spec)
    t_ag = allgather_full_mesh_time_s(m_global * k * itemsize, n_ranks,
                                      spec)
    return max(t_gemm, t_ag) + t_ag / max(n_ranks, 1)


def gemm_rs_time_s(m_global: int, n_cols: int, k: int, n_ranks: int,
                   itemsize: int, spec: ChipSpec | None = None) -> float:
    """Overlapped GEMM+RS ~ max(compute, comm) + one chunk's fill."""
    spec = spec or chip_spec()
    t_gemm = gemm_time_s(m_global, n_cols, k, itemsize, spec)
    t_rs = reduce_scatter_ring_time_s(m_global * n_cols * itemsize,
                                      n_ranks, spec)
    return max(t_gemm, t_rs) + t_rs / max(n_ranks, 1)


# ---------------------------------------------------------------------------
# The inter tier of a two-tier group (ops/two_level.py, ops/hierarchical.py).
# ---------------------------------------------------------------------------

def dcn_collective_time_s(nbytes: int, n_hosts: int,
                          spec: ChipSpec | None = None) -> float:
    """A ring collective over the inter tier: n_hosts - 1 hops of one
    host's shard of ``nbytes``."""
    spec = spec or chip_spec()
    if n_hosts <= 1:
        return 0.0
    shard = nbytes / n_hosts
    return (n_hosts - 1) * (shard / (spec.dcn_gbps * 1e9)
                            + spec.dcn_latency_s)


def _dcn_hop_time_s(nbytes: int, spec: ChipSpec) -> float:
    """One hop over the inter tier: its latency and the payload at its
    rate."""
    return nbytes / (spec.dcn_gbps * 1e9) + spec.dcn_latency_s


def ag_gemm_2d_time_s(m_global: int, n_cols: int, k: int, n_intra: int,
                      n_inter: int, itemsize: int,
                      spec: ChipSpec | None = None) -> float:
    """The two-tier AG+GEMM (``ops/hierarchical.ag_gemm_2d``): the slice's
    fused AG+GEMM fills the pipeline, then each of the n_inter - 1 inter
    hops overlaps one slice block's GEMM — max(hop, slice GEMM) a remote
    slice. The inter hop's latency makes AUTO decline the path at small
    row counts."""
    spec = spec or chip_spec()
    m_slice = max(m_global // max(n_inter, 1), 1)
    t_intra = ag_gemm_time_s(m_slice, n_cols, k, n_intra, itemsize, spec)
    if n_inter <= 1:
        return t_intra
    t_slice_gemm = gemm_time_s(m_slice, n_cols, k, itemsize, spec)
    t_hop = _dcn_hop_time_s(m_slice * k * itemsize, spec)
    return t_intra + (n_inter - 1) * max(t_hop, t_slice_gemm)


def gemm_rs_2d_time_s(m_global: int, n_cols: int, k: int, n_intra: int,
                      n_inter: int, itemsize: int,
                      spec: ChipSpec | None = None) -> float:
    """The two-tier GEMM+RS (``ops/hierarchical.gemm_rs_2d``): a slice
    chunk's fused GEMM+RS a step, and the chunk's inter hop (already
    reduced in the slice: 1/n_intra of its bytes) under the next chunk's
    compute; the first chunk fills the pipeline."""
    spec = spec or chip_spec()
    m_slice = max(m_global // max(n_inter, 1), 1)
    t_chunk = gemm_rs_time_s(m_slice, n_cols, k, n_intra, itemsize, spec)
    if n_inter <= 1:
        return t_chunk
    t_hop = _dcn_hop_time_s(m_slice // max(n_intra, 1) * n_cols * itemsize,
                            spec)
    return t_chunk + (n_inter - 1) * max(t_hop, t_chunk)
