"""DEM particle subsystem of the port (counterpart of dedflow_tpu/dem/):
cell-list contacts, the grid-resident contact sweep (kernel K11,
csrc/dem_contact.cu), explicit integration and the FEM-DEM drag coupling.
"""

from dedflow_tpu_torch.dem.particles import ParticleState, particle_state
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.integrate import DEMConfig, dem_step, dem_run
