"""Wire-codec kernels: plain PyTorch versions (``ref``), the hand-written
CUDA kernels (``csrc/``, wrapped in ``sketch_wire``) and the dispatch
between them (``ops``). Nothing is built when this package is imported."""
