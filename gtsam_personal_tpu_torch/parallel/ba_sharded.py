"""Bundle adjustment dealt over ranks by camera.

JAX counterpart: gtsam_personal_tpu/parallel/ba_sharded.py (shard_ba,
sharded_ba_step). The JAX module places the observations sharded on a
device mesh and lets GSPMD insert the collectives into the single-device
try step. PyTorch has no GSPMD, so here `shard_ba` deals the observations
by camera (parallel/dist_ba.py:build_dist_layout) and `sharded_ba_step` is
dist_ba's explicit try step: the all-reduces are in the program text.
"""

from gtsam_personal_tpu_torch.parallel import dist_ba
from gtsam_personal_tpu_torch.parallel.mesh import Mesh
from gtsam_personal_tpu_torch.sfm import ba
from gtsam_personal_tpu_torch.sfm.ba_layout import BALayout


def shard_ba(state: ba.BAState, obs: ba.BAObservations, layout: BALayout,
             mesh: Mesh):
    """(state with its cameras padded to the ranks, obs, this rank's
    DistBALayout), on the mesh's device; `layout` gives C and P."""
    state = ba.BAState(*(x.to(mesh.device) for x in state))
    obs = ba.BAObservations(*(x.to(mesh.device) for x in obs))
    return (dist_ba.pad_cameras(state, mesh.size), obs,
            dist_ba.build_dist_layout(obs, layout.C, layout.P, mesh))


def sharded_ba_step(state, obs, layout: dist_ba.DistBALayout, lam,
                    cg_maxiter=25):
    """The BA try step on the dealt problem: (new state, its error), the
    same on every rank; the cameras stay padded."""
    return dist_ba.dist_ba_try_step(state, obs, layout, lam, layout.mesh,
                                    cg_maxiter=cg_maxiter)
