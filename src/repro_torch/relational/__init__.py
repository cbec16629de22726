"""The relational engine of the port: tables, data, statistics, operators,
the planner and the TPC-H queries (counterpart of ``repro.relational``)."""
