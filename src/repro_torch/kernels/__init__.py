# Hand-written CUDA kernels for the paper's three hot loops (csrc/*.cu),
# their plain PyTorch versions (ref.py) and the wrappers the rest of the
# package calls (ops.py). _build.py compiles and binds the kernels at first use.
