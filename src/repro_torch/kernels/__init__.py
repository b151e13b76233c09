"""Hand-written Hopper (sm_90a) kernels for the serving hot spots, each
beside its plain PyTorch version.

flash_attention — prefill attention (GQA/SWA), CUDA C++ in csrc/
paged_attention — decode over a paged KV cache (block tables), CUDA C++
ssd_scan        — Mamba2 SSD chunk scan with initial/final state, CUDA C++
ops             — the entry points: CUDA tensor -> kernel, CPU -> plain
build           — nvcc build at first use + ctypes loader
"""
