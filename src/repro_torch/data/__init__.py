"""Synthetic serving workloads and the training data pipeline of the port."""
