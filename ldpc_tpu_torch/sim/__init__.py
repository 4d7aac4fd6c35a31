from ldpc_tpu_torch.sim.importance import (
    FloorEstimate,
    biased_awgn_llr,
    estimate_event_probability,
    estimate_trapping_floor,
)
from ldpc_tpu_torch.sim.montecarlo import (
    LDPCSimulator,
    SimulationConfig,
    SimulationResult,
    create_test_decoders,
    point_generator,
    simulate_single_snr,
)
