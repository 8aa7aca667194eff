"""The plain reference: directions, keys and the round's arithmetic."""
