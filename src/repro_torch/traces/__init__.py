"""Workload traces: ShareGPT-calibrated chat sessions, MetaGPT-style agent
projects."""
