"""Process exit codes the port's CLI uses (a copy of the values in the JAX
package's exit-code table, so the two CLIs route alike without the port
importing the JAX package)."""

OK_RC = 0
FAIL_RC = 1
USAGE_RC = 2  # argparse / flag-validation error (deterministic, no retry)
ANOMALY_RC = 77  # consecutive non-finite train steps (--anomaly-limit)
