"""``repro_torch.topo``: communication topologies for decentralized
aggregation (port of ``repro.topo``).

Graph construction, Metropolis–Hastings mixing matrices and spectral
diagnostics (``graph``, a numpy copy of the reference's) and the row-native
gossip mixing pass with carbon-aware reweighting (``gossip``).  The
``"gossip"`` strategy in ``repro_torch.api`` is built on this package.
"""
from repro_torch.topo.graph import (GRAPHS, MixingPlan, consensus_rounds, is_connected,
                                    metropolis_weights, plan, slem, spectral_gap)
from repro_torch.topo.gossip import carbon_reweight, consensus_distance, mix_rows

__all__ = [
    "carbon_reweight", "consensus_distance", "consensus_rounds", "GRAPHS",
    "is_connected", "metropolis_weights", "mix_rows", "MixingPlan", "plan",
    "slem", "spectral_gap",
]
