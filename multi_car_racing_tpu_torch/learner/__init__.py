"""The learner: PPO over batched envs, its networks and its evaluation."""
