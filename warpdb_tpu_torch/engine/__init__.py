"""Execution engine of the port: compiler, optimizer, UDFs, executors."""
