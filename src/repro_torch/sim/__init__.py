"""Discrete-event simulation of agent serving (drives repro_torch.core
policies): the port's copy of the reference's pure-Python ``sim``."""
from repro_torch.sim.engine import FaultPlan, Simulation
from repro_torch.sim.hardware import CONFIGS, HwConfig, small_test_hw
from repro_torch.sim.metrics import SimResult

__all__ = ["CONFIGS", "FaultPlan", "HwConfig", "SimResult", "Simulation", "small_test_hw"]
