"""Config module for --arch (re-exports from arch_defs; see there)."""
from repro_torch.configs.arch_defs import *  # noqa: F401,F403
