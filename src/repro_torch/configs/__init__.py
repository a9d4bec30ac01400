"""Workload configurations (graph generators' parameters)."""
