/* Training store (the reference's Pinia store,
 * Visualization_frontend/src/store/training.ts): owns the WebSocket, the
 * metric streams, and the start/stop actions.  Views subscribe to signals
 * instead of talking to the socket themselves.
 *
 * Server message contract (deepflows_tpu/viz/server.py, which mirrors the
 * reference Visualization_backend/server.py:348-357):
 *   {type:"metrics",   data:{epoch,batch,loss,accuracy}}  every 10 batches
 *   {type:"epoch",     data:{epoch,test_acc,lr,epoch_time}} per epoch
 *   {type:"resources", data:{cpu_percent,memory_percent}}  at 1 Hz
 *   {type:"status",    data:"training"|"stopped"|...}      transitions
 */

import { signal, defineStore } from '../reactive.js';
import { WebSocketClient, wsUrl } from '../ws.js';
import { api } from '../api.js';

const MAX_POINTS = 2000; // bound chart memory on long runs (ref keeps 500)
const MAX_RESOURCE_POINTS = 180;

export const useTrainingStore = defineStore(() => {
  const losses = signal([]);
  const accs = signal([]);
  const testAccs = signal([]);
  const lrs = signal([]);
  const cpu = signal([]);
  const ram = signal([]);
  const status = signal('idle');
  const wsState = signal('connecting');
  const current = signal({}); // {epoch,batch,loss,accuracy,test_acc,lr,...}
  const isTraining = signal(false);

  const push = (sig, v, cap = MAX_POINTS) => {
    sig.value.push(v);
    if (sig.value.length > cap) sig.value.shift();
    sig.touch();
  };

  const handleMessage = (msg) => {
    if (msg.type === 'metrics') {
      push(losses, msg.data.loss);
      push(accs, msg.data.accuracy);
      current.value = { ...current.value, ...msg.data };
    } else if (msg.type === 'epoch') {
      push(testAccs, msg.data.test_acc);
      push(lrs, msg.data.lr);
      current.value = { ...current.value, ...msg.data };
    } else if (msg.type === 'resources') {
      push(cpu, msg.data.cpu_percent, MAX_RESOURCE_POINTS);
      push(ram, msg.data.memory_percent, MAX_RESOURCE_POINTS);
    } else if (msg.type === 'status') {
      status.value = String(msg.data);
      isTraining.value = msg.data === 'training' || msg.data === 'loading data';
    }
  };

  let ws = null;
  const initWebSocket = () => {
    if (ws) return;
    ws = new WebSocketClient(wsUrl());
    ws.onMessage(handleMessage);
    ws.onState((s) => {
      wsState.value = s;
    });
    ws.connect();
  };

  const startTraining = async (config) => {
    losses.value = [];
    accs.value = [];
    testAccs.value = [];
    lrs.value = [];
    const res = await api.startTraining(config);
    status.value = res.status || 'started';
    isTraining.value = true;
    return res;
  };

  const stopTraining = () => api.stopTraining();

  return {
    losses, accs, testAccs, lrs, cpu, ram,
    status, wsState, current, isTraining,
    initWebSocket, startTraining, stopTraining,
  };
});
