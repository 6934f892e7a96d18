"""Plain references of the benchmark's paths: numpy and plain torch, with no
import of the program or of any JAX package. Each works out again whatever
the program derives from the inputs (layouts, plans, preconditioners)."""
