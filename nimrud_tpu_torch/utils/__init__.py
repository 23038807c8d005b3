"""Workload helpers of the port."""
