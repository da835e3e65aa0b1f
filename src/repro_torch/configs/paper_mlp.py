"""The paper's own architecture: 62-30-10 MLP for MNIST (Section III).

Not a ModelConfig — built on ``repro_torch.nn.mlp_paper`` with
signed-magnitude 8-bit quantization and the 32-config approximate MAC.
The canonical hyperparameters (copy of ``repro.configs.paper_mlp``).
"""
N_INPUT = 62
N_HIDDEN = 30
N_OUTPUT = 10
N_PHYSICAL_NEURONS = 10
FSM_STATES = 5
TRAIN_STEPS = 1500
LR = 3e-3
