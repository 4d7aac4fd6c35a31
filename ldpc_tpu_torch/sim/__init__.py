from ldpc_tpu_torch.sim.montecarlo import (
    LDPCSimulator,
    SimulationConfig,
    SimulationResult,
    create_test_decoders,
    point_generator,
    simulate_single_snr,
)
