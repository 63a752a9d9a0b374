"""The plain reference: TFHE (``tfhe.py``) and the sign network over it
(``net.py``).  Imports nothing of the program or of JAX."""
