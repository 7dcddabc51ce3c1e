"""Dataset schema and the device-resident frame store."""
