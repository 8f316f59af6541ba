"""Analytic performance model of the port."""
