"""Plain references that decide ``correct``: NumPy and plain PyTorch in
float32 with TF32 off.  They import nothing of the program, JAX or the JAX
package, and take nothing the program made: each works out again what the
program derived from the benchmark's inputs (the normalisation, the
sampled neighbourhoods, the optimizer's state)."""
