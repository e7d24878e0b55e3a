"""Observability: the device ledger (pinned residents and HBM
headroom) and the flight recorder."""
