"""Network substrate, copied from the reference (pure numpy): link
profiles, TCP parameters, the closed-form transport model and the
event-granular DES. The reference's device transport plane is not ported
yet."""

from repro_torch.transport.link import (
    AFRICA,
    AFRICA_RURAL,
    AFRICA_URBAN,
    ASIA,
    AUSTRALIA,
    EUROPE,
    GLOBAL_AVG,
    LAB,
    LinkProfile,
    N_AMERICA,
    PROFILES,
)
from repro_torch.transport.model import (
    ClientRoundOutcome,
    HandshakeResult,
    IdleResult,
    TransferResult,
    classify,
    client_round,
    effective_rtt,
    goodput_bps,
    handshake,
    idle_phase,
    retry_round,
    transfer,
)
from repro_torch.transport.des import (
    CohortOutcome,
    GridOutcome,
    SimOutcome,
    sim_client_round,
    sim_cohort_round,
    sim_grid_round,
)
from repro_torch.transport.params import (
    BIG_BUFFER,
    DEFAULT,
    TRANSPORT_PROFILES,
    TUNED_EDGE,
    RetryPolicy,
    TcpParams,
    transport_profile,
)


__all__ = [
    "LinkProfile",
    "PROFILES",
    "LAB",
    "AFRICA",
    "AFRICA_URBAN",
    "AFRICA_RURAL",
    "GLOBAL_AVG",
    "N_AMERICA",
    "EUROPE",
    "ASIA",
    "AUSTRALIA",
    "TcpParams",
    "RetryPolicy",
    "DEFAULT",
    "TUNED_EDGE",
    "BIG_BUFFER",
    "TRANSPORT_PROFILES",
    "transport_profile",
    "handshake",
    "idle_phase",
    "transfer",
    "client_round",
    "retry_round",
    "classify",
    "goodput_bps",
    "effective_rtt",
    "HandshakeResult",
    "IdleResult",
    "TransferResult",
    "ClientRoundOutcome",
    "SimOutcome",
    "CohortOutcome",
    "GridOutcome",
    "sim_client_round",
    "sim_cohort_round",
    "sim_grid_round",
]
