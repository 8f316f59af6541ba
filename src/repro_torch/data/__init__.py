"""Synthetic serving workloads of the port."""
