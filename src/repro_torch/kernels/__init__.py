"""Kernels of the port: plain versions (``ref``), the CUDA kernels'
wrappers (``fwht``, ``srht``) and the dispatch registry (``ops``)."""
