"""CLI entry points: train (IC_only.py parity), evaluate (eval.py parity),
research (thresh.py / large_scale.py parity); the port's copies of the JAX
package's ``cli``."""
