"""repro_torch -- the PyTorch/CUDA port of the reference package.

The UFS scheduler (``core``) and the architecture configs (``configs``) are
copies of the reference's framework-free modules; ``kernels`` holds the
hand-written Hopper kernels, ``models`` the dense GQA decoder, ``serving``
the continuous-batching engine and ``launch`` the serving driver.  Entry
points run on the CUDA device unless the caller asks for the CPU.
"""
