from repro_torch.apps.jacobi import JacobiApp

__all__ = ["JacobiApp"]
