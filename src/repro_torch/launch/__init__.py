"""Entry points and the run's layout: serving
(``serve_policy.PolicyServer``), the quickstart, the actor mesh of a
sharded run (``mesh``) and the card's micro-benchmarks and sweeps."""
