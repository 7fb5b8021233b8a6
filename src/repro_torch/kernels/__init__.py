# Hand-written Hopper kernels, one package each: <name>.py (loader and
# wrapper), csrc/ (CUDA sources), ref.py (plain PyTorch version), ops.py
# (autograd-aware entry points that pick kernel or plain version by device).
