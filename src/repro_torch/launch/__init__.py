"""Command-line entry points of the port, and the LM's step builders on a
mesh (``launch.steps``)."""
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import build_step, input_specs
