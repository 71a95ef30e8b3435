from nkbx_torch.parallel.mesh import (A10B, Mesh, make_mesh, mesh_from_cfg, param_shardings,
                                      state_shardings)

__all__ = ["A10B", "Mesh", "make_mesh", "mesh_from_cfg", "param_shardings", "state_shardings"]
