"""Kernels of the port: plain versions (``ref``), the CUDA kernels'
wrappers (``fwht``, ``srht``, ``codec``, ``flash_attention``) and the
dispatch registry (``ops``)."""
