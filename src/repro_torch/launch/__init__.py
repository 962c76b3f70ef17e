"""Serving: the continuous-batching ``serve_policy.PolicyServer``."""
