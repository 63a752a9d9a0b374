"""redsec-tpu on PyTorch and CUDA: encrypted (CGGI/TFHE) BNN inference on an
NVIDIA Hopper GPU.

A port of the JAX package ``redsec_tpu`` with the same module names, so each
counterpart is easy to find.  The port never imports JAX nor anything of the
JAX package; it keeps its own copies of the numpy-only modules it needs.

Subpackages
-----------
- ``crypto``  : parameters, keygen (numpy), the exact CRT-NTT, the batched
                programmable bootstrap and its hand-written CUDA kernels
                (``csrc/pbs.cu``, bound in ``crypto/kernels.py``).
- ``formats`` : ``var_prep.dat`` reader/writer, pixel conversion.
- ``models``  : model IR, prep pass and the model zoo.
- ``runtime`` : plaintext oracle, certified PBS ranges, encrypted engine.
- ``ops``     : encrypted operators over LWE ciphertext tensors.
- ``compiler``: netlist wizard and compiler, weight convert, and the BYON
                trainers on torch autograd (``train``, ``train_relu``).
- ``native``  : the OpenMP C++ CGGI core (g++, ctypes), the CPU oracle.
- ``convert`` : carries the JAX package's keys and model plans across.
- ``entry``   : ``entry()``, a small encrypted forward and its arguments.

Entry points default to ``device="cuda"`` and raise without CUDA unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
