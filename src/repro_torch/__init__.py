"""Shoal on PyTorch: the PGAS Active-Message library of "A PGAS
Communication Library for Heterogeneous Clusters" (Sharma & Chow, 2021)
for one NVIDIA H100.

A port of the JAX package ``repro`` with the same module names; it
imports neither JAX nor ``repro``.  Subpackages:

  core       the Shoal library (AM wire, GAScore, ops, address space)
  runtime    Galapagos analogue (topology, transports, routing)
  actors     mailboxes: tiny AMs and acks coalesced into one exchange
  kernels    hand-written CUDA kernels for Hopper + their plain versions
  apps       the paper's Jacobi application

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
