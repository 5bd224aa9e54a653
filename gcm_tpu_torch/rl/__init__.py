"""RL on the card: action distributions, vectorised environments,
actor-critic policies over the memory cores, and the A2C and PPO
trainers."""
