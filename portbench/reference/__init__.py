"""The benchmark's plain reference: a decoder and a PSNR of its own, which
import nothing of the port or of the JAX package."""
