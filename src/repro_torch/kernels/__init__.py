"""Hand-written Hopper (sm_90a) kernels for the attention hot spots, each
beside its plain PyTorch version.

flash_attention — prefill attention (GQA/SWA), CUDA C++ in csrc/
paged_attention — decode over a paged KV cache (block tables), CUDA C++
ops             — the entry points: CUDA tensor -> kernel, CPU -> plain
build           — nvcc build at first use + ctypes loader
"""
