"""The benchmark of ``incrementalinference_torch`` on one NVIDIA H100
(see README.md)."""
