"""PyTorch/CUDA port of the serving system: the dense decoder, the
continuous-batching engine and the telemetry/mitigation plane, with the
attention kernels written by hand for NVIDIA Hopper (sm_90a).

Subpackages mirror the JAX package ``repro`` module for module
(``configs``, ``core``, ``kernels``, ``models``, ``serving``), so each
module's counterpart carries the same name.  This package imports torch and
numpy only; it shares no code with the JAX package.
"""
