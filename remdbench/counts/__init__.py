"""The yardstick's arithmetic: operations and bytes from the topology,
and the card's published peaks."""
