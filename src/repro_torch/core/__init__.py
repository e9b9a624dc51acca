"""SYMPHONY core: advisory requests, tiered KV store, node manager."""
