"""Serving: paged allocator, transfer engine, cost model, engine, backends."""
