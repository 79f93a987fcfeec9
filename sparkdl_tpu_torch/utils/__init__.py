"""Shared utilities of the port."""
