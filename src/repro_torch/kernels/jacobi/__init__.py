from repro_torch.kernels.jacobi.jacobi import jacobi_sweep_cuda
from repro_torch.kernels.jacobi.ops import (jacobi_band_step, jacobi_run,
                                            jacobi_step)
from repro_torch.kernels.jacobi.ref import jacobi_band_ref, jacobi_step_ref

__all__ = ["jacobi_step", "jacobi_run", "jacobi_step_ref",
           "jacobi_band_step", "jacobi_band_ref", "jacobi_sweep_cuda"]
