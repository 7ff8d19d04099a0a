"""The visible cards, who can reach whom, and the ring order —
counterpart of the JAX package's ``runtime/topology.py``.

The reference reads TPU chip coordinates and walks the ICI torus for a
ring whose every hop is one link. An NVLink host (an HGX H100 board)
joins its cards all to all through NVSwitch, so every peer is one hop
away and the ring is simply the rank order; on one card the ranks are
virtual and the ring is the rank order too.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    num_devices: int
    platform: str                    # "cuda" or "cpu"
    names: tuple                     # card names (empty on the CPU)
    peer_access: tuple               # [i][j]: card i can map card j's memory
    virtual: bool                    # all ranks on one card

    @property
    def all_to_all(self) -> bool:
        """Every pair of distinct cards reaches each other directly."""
        n = self.num_devices
        return all(self.peer_access[i][j] for i in range(n)
                   for j in range(n) if i != j)


def detect_topology(devices) -> Topology:
    """The topology of ``devices`` (a rank group's ``torch.device`` list).
    Peer access is what ``torch.cuda.can_device_access_peer`` reports; a
    card always reaches itself."""
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if not devs or devs[0].type != "cuda":
        return Topology(n, "cpu", (), tuple((True,) * n for _ in range(n)),
                        virtual=False)
    idx = [d.index for d in devs]
    names = tuple(torch.cuda.get_device_name(i) for i in idx)
    access = tuple(tuple(a == b or torch.cuda.can_device_access_peer(a, b)
                         for b in idx) for a in idx)
    return Topology(n, "cuda", names, access,
                    virtual=n > 1 and len(set(idx)) == 1)


def ring_order(topology: Topology) -> list[int]:
    """The ring the ring collectives walk: the rank order, every hop one
    NVLink (or, on one card, one copy through its memory). Raises when
    some pair of cards cannot reach each other — no ring of direct hops
    exists then."""
    if topology.platform == "cuda" and not topology.all_to_all:
        raise RuntimeError("cards without peer access to each other "
                           f"({topology.names}): the port's ring and its "
                           "peer-pointer pushes need every pair to reach "
                           "each other (an NVLink / NVSwitch host)")
    return list(range(topology.num_devices))
