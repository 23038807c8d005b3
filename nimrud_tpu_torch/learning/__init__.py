"""Classifiers of the port."""
