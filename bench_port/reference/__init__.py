"""Plain references that decide `correct`.

Plain PyTorch, written from the semantics of upstream IncrementalInference
(and its JAX package), never from the port's code: nothing here imports the
port, JAX or the JAX package.  Every function takes a ``dtype``; float64 is
the reference, and a lower one (bfloat16, or float32 under TF32) is the
control that the comparison has to fail.
"""
