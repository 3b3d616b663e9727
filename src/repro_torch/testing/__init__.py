"""Test support for the port: deterministic fault injection
(``testing.faults``) for the resilience layer of ``core.resilience``."""
