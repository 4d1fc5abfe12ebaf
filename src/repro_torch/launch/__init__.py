"""Launchers: device meshes and the ranks behind them, the serving and
training CLIs."""
from repro_torch.launch.mesh import (  # noqa: F401
    make_production_mesh,
    make_test_mesh,
)
