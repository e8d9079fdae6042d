"""The port's copies of the JAX package's observability modules that the
serving path calls (metrics, tracing, events, reqlog, stepstats), so a
dashboard, trace or flight dump reads either package's replica alike."""
