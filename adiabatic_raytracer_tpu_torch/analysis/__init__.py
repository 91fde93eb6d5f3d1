"""Readers of the port's clear-text outputs (numpy only)."""
